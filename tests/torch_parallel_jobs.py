"""Rank jobs of tests/test_torch_parallel.py. The ranks are spawned
processes that import this module, so it imports torch and the port only.
Each job also runs with mesh=None: that is the one-process reference."""

import logging

import numpy as np
import torch

from targetdiff_tpu_torch.cli.train_diffusion import validate
from targetdiff_tpu_torch.config import Config
from targetdiff_tpu_torch.data.batch import ComplexBatch
from targetdiff_tpu_torch.data.synth import synth_batch
from targetdiff_tpu_torch.models.score_model import DiffusionModel
from targetdiff_tpu_torch.parallel.mesh import gather_rows, row_range
from targetdiff_tpu_torch.sampling import sample_testset
from targetdiff_tpu_torch.trainer import create_train_state, make_eval_step, make_train_step
from targetdiff_tpu_torch.utils.train import get_optimizer

# the flagship at small width (tests/test_fast_forward.py:small_flagship)
SMALL = dict(
    model_mean_type="C0", beta_schedule="sigmoid", beta_start=1e-7, beta_end=2e-3,
    v_beta_schedule="cosine", v_beta_s=0.01, num_diffusion_timesteps=10,
    loss_v_weight=100.0, sample_time_method="symmetric", time_emb_dim=0,
    time_emb_mode="simple", center_pos_mode="protein", node_indicator=True,
    model_type="uni_o2", num_blocks=1, num_layers=2, hidden_dim=32, n_heads=4,
    edge_feat_dim=4, num_r_gaussian=20, knn=8, num_node_types=8, act_fn="relu",
    norm=True, cutoff_mode="knn", ew_net_type="global", num_x2h=1, num_h2x=1,
    r_max=10.0, x2h_out_fc=False, sync_twoup=False,
)
OPT = dict(type="adam", lr=5e-4, weight_decay=0.0, beta1=0.95, beta2=0.999, max_grad_norm=8.0)
NP_, NL, FEAT, CLASSES = 24, 8, 27, 13
# (graph or denoiser, impl, time sampling): every impl the model has
TRAIN_CASES = [(net, impl, timing) for net in ("knn", "hybrid")
               for impl in ("fast", "eager") for timing in ("symmetric", "importance")]
TRAIN_CASES += [("knn", "fast_pl", "importance"), ("egnn", "eager", "symmetric"),
                ("knn", "fast_bf16", "symmetric"), ("hybrid", "fast_bf16_pl", "importance")]
NETS = {"knn": {}, "hybrid": dict(cutoff_mode="hybrid"), "egnn": dict(model_type="egnn")}
SAMPLERS = ("ddpm", "ddim")


def small_model(seed=0, **overrides) -> DiffusionModel:
    torch.manual_seed(seed)
    return DiffusionModel(Config(dict(SMALL, **overrides)), FEAT, CLASSES, device="cpu",
                          max_protein=NP_, max_ligand=NL)


def small_batch(b: int, seed: int) -> ComplexBatch:
    return synth_batch(np.random.default_rng(seed), b, max_protein=NP_, max_ligand=NL,
                       n_protein_range=(16, NP_), n_ligand_range=(4, NL))


def step_result(model, state, metrics) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.net.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().clone() for n, p in model.net.named_parameters()},
            "Lt_history": state.Lt_history.clone(), "Lt_count": state.Lt_count.clone()}


def train_case(mesh, case) -> dict:
    """One train step of 4 complexes from seeded weights, with protein
    noise; under 'importance' every timestep bucket is ready, so the step
    draws from the Lt EMA."""
    net, impl, timing = case
    model = small_model(**NETS[net])
    state = create_train_state(model, get_optimizer(Config(OPT), model.parameters()))
    if timing == "importance":
        state.Lt_count.fill_(20.0)
        state.Lt_history = torch.rand(model.num_timesteps,
                                      generator=torch.Generator().manual_seed(9)) + 0.1
    step = make_train_step(model, pos_noise_std=0.1, time_sampling=timing, impl=impl,
                           mesh=mesh)
    state, metrics = step(state, small_batch(4, 3), torch.Generator().manual_seed(1))
    return step_result(model, state, metrics)


def pockets(counts=(14, 18, 22), seed=5):
    rng = np.random.default_rng(seed)
    return [{"protein_pos": rng.normal(size=(n, 3)).astype(np.float32) * 3,
             "protein_feat": (rng.random((n, FEAT)) > 0.7).astype(np.float32)} for n in counts]


def sample_case(mesh, sampler: str) -> list:
    """3 pockets x 3 samples in chunks of 4 rows: the last chunk's one row
    leaves rank 0 of two with none."""
    return sample_testset(small_model(), pockets(), 3, torch.Generator().manual_seed(4),
                          num_steps=3, rng=np.random.default_rng(5), chunk_rows=4,
                          sampler=sampler, mesh=mesh)


def validation_case(mesh) -> float:
    """`validate` over batches of 4, 3 (split 1 / 2) and 1 row (rank 0 none)."""
    model = small_model()
    batches = [small_batch(4, 11), small_batch(3, 12), small_batch(1, 13)]
    return validate(model, make_eval_step(model, mesh=mesh), batches, 3,
                    logging.getLogger("torch_parallel_jobs"), 0, num_t=3)


def gather_case(mesh) -> dict:
    """gather_rows of 5 rows of float, int64 and bool tensors."""
    full = {"f": torch.arange(15.0).reshape(5, 3) * 1.5 - 4.0,
            "i": torch.arange(10).reshape(5, 2) * 7 - 20,
            "b": torch.tensor([True, False, True, True, False])}
    if mesh is None:
        return full
    start, stop = row_range(5, mesh)
    return {k: gather_rows(v[start:stop], 5, mesh) for k, v in full.items()}


def given_draws_case(mesh, state_dict, batch, draws) -> dict:
    """The step of tests/test_torch_train.py's JAX comparison: the small
    setup's weights and batch (2 complexes), the JAX step's draws given."""
    model = DiffusionModel(Config(SMALL), FEAT, CLASSES, device="cpu", max_protein=16,
                           max_ligand=8)
    model.net.load_state_dict(state_dict)
    state = create_train_state(model, get_optimizer(Config(OPT), model.parameters()))
    step = make_train_step(model, pos_noise_std=0.0, mesh=mesh)
    state, metrics = step(state, batch, None, *draws)
    return step_result(model, state, metrics)


def all_jobs(mesh, state_dict, batch, draws) -> dict:
    return {"train": {case: train_case(mesh, case) for case in TRAIN_CASES},
            "sample": {s: sample_case(mesh, s) for s in SAMPLERS},
            "validation": validation_case(mesh), "gather": gather_case(mesh),
            "given_draws": given_draws_case(mesh, state_dict, batch, draws)}


def fail_on_rank_1(mesh):
    """Rank 1 raises; rank 0 waits in a collective for it."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.all_reduce(torch.ones(4))
    return "unreachable"
