"""The uni_o2 options the released model does not use, and the bf16 model,
on the port's eager path against the JAX package's XLA path on the CPU:
`ew_net_type` r / m / none, the x2h output MLP (`x2h_out_fc`), `num_x2h` /
`num_h2x` > 1, `sync_twoup`, silu and the learnable swish, MLPs without
LayerNorm, no edge features in the attention inputs, the 'simple' and 'sin'
time embeddings, each alone, and two combinations: V1, the reference's
class defaults for the two edge options (ew_net_type r, x2h_out_fc), and V2,
every other option at once. Small width (2 layers, hidden 32, 4 heads, kNN
8); inputs from a numpy seed; weights carried across by
`flax_params_to_state_dict`.

Float32 bars: the forward at tests/test_fast_forward.py's (positions atol
2e-4 / rtol 1e-3, logits 2e-3 / 1e-2), the loss with JAX's draws within 1e-4
relative, every gradient within 5e-3 of its tensor's largest |JAX| entry
(at least 1e-3).
The bf16 model (`DiffusionModel(model_dtype=torch.bfloat16)`) against JAX's
`DiffusionModel(dtype=jnp.bfloat16)`: outputs within 2e-2 of their scale
(tools/kparity.py's bf16 bar), the loss within 1e-2 relative, and the
gradients by their median over the tensors (BF16_GRAD_MEDIAN of each
tensor's scale); the worst tensor is printed, not held: under cancellation
two bf16 orders part far (PERF.md, bf16 training)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu.models.score_model import DiffusionModel as JaxDiffusionModel
from targetdiff_tpu_torch.data.batch import from_numpy
from targetdiff_tpu_torch.models import uni_transformer as ut
from targetdiff_tpu_torch.models.fast_forward import (eager_supported, require_kernels,
                                                      resolve_impl)
from targetdiff_tpu_torch.models.score_model import DiffusionModel
from targetdiff_tpu_torch.utils.port import flax_params_to_state_dict, state_dict_to_flax_params
from tests.test_fast_forward import NUM_CLASSES, PROTEIN_DIM, batch_mult8, small_flagship
from tests.test_torch_block_vjp import jax_draws
from tests.test_torch_ddim import MARGIN, POS_ATOL, _centered, _gumbel_margin
from tests.test_torch_score_model import LOGIT_TOL, POS_TOL

torch.set_num_threads(2)

V1 = dict(ew_net_type="r", x2h_out_fc=True)
V2 = dict(ew_net_type="m", num_x2h=2, num_h2x=2, sync_twoup=True, act_fn="swish", norm=False,
          time_emb_mode="sin", time_emb_dim=8)
OPTIONS = {
    "ew_r": dict(ew_net_type="r"),
    "ew_m": dict(ew_net_type="m"),
    "ew_none": dict(ew_net_type="none"),
    "x2h_out_fc": dict(x2h_out_fc=True),
    "x2h_out_fc_no_norm": dict(x2h_out_fc=True, norm=False),
    "num_x2h_2": dict(num_x2h=2),
    "num_h2x_2": dict(num_h2x=2),
    "sync_twoup": dict(sync_twoup=True),
    "silu": dict(act_fn="silu"),
    "swish": dict(act_fn="swish"),
    "no_norm": dict(norm=False),
    "edge_feat_0": dict(edge_feat_dim=0),
    "time_simple": dict(time_emb_dim=4),
    "time_sin": dict(time_emb_dim=8, time_emb_mode="sin"),
    "V1": V1,
    "V2": V2,
    "V2_hybrid": dict(V2, cutoff_mode="hybrid"),
}
T_STEPS = np.array([3, 7])
GRAD_ATOL_SCALE = 5e-3
BF16_BAR = 2e-2  # outputs, of their scale (tools/kparity.py:91)
BF16_LOSS_REL = 1e-2
# the median tensor's largest error over its scale: measured 0.7e-2 (EGNN)
# to 2.4e-2 (no norm) at this width, where the float32 model lies as far
# from JAX's bf16 gradients (1.1e-2 to 2.7e-2): bf16's own noise. A wrong
# option (V2 without sync_twoup) lands at 0.14.
BF16_GRAD_MEDIAN = 5e-2


def setup(overrides, jax_dtype=None, model_dtype=torch.float32):
    """(JAX model, JAX params, JAX batch, port model, port batch) for the
    small flagship with `overrides`, the port's weights bridged from JAX's."""
    cfg = small_flagship()
    cfg.update(overrides)
    jbatch = batch_mult8()
    jmodel = JaxDiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, max_protein=16, max_ligand=8,
                               dtype=jax_dtype)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch)
    model = DiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, device="cpu", max_protein=16,
                           max_ligand=8, model_dtype=model_dtype)
    model.net.load_state_dict(flax_params_to_state_dict(jax.device_get(params)))  # strict
    return jmodel, params, jbatch, model, from_numpy(*[np.asarray(a) for a in jbatch])


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _forward(jmodel, params, jbatch, model, batch):
    ref = jmodel.apply(params, jbatch, jbatch.ligand_pos, jbatch.ligand_v, jnp.asarray(T_STEPS))
    with torch.no_grad():
        out = model.apply(batch, batch.ligand_pos, batch.ligand_v,
                          time_step=torch.from_numpy(T_STEPS))
    return out, ref


def _loss_and_grads(jmodel, params, jbatch, model, batch):
    """(JAX loss, JAX grads as the port's state_dict, port output, port grads)
    with the same t and JAX's draws."""
    key, t = jax.random.PRNGKey(5), np.array([2, 7])

    def loss_fn(p):
        return jmodel.get_diffusion_loss(p, key, jbatch, time_step=jnp.asarray(t))["loss"]

    la, ga = jax.value_and_grad(loss_fn)(params)
    eps, u = jax_draws(key, jbatch, jmodel.num_classes)
    model.net.zero_grad()
    out = model.get_diffusion_loss(batch, time_step=torch.from_numpy(t), pos_noise=eps,
                                   v_uniform=u, impl="eager")
    out["loss"].backward()
    want = {k: v.numpy() for k, v in flax_params_to_state_dict(jax.device_get(ga)).items()}
    got = {k: p.grad.numpy() for k, p in model.net.named_parameters()}
    assert sorted(got) == sorted(want)
    return float(la), want, out, got


@pytest.mark.parametrize("name", list(OPTIONS))
def test_forward_matches_jax_xla(name):
    jmodel, params, jbatch, model, batch = setup(OPTIONS[name])
    assert model.impl == "eager"
    out, ref = _forward(jmodel, params, jbatch, model, batch)
    lmask = np.asarray(jbatch.ligand_mask)[..., None]
    np.testing.assert_allclose(_np(out["pred_ligand_pos"]) * lmask,
                               np.asarray(ref["pred_ligand_pos"]) * lmask, **POS_TOL)
    np.testing.assert_allclose(_np(out["pred_ligand_v"]) * lmask,
                               np.asarray(ref["pred_ligand_v"]) * lmask, **LOGIT_TOL)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_loss_and_grads_match_jax_xla(name):
    jmodel, params, jbatch, model, batch = setup(OPTIONS[name])
    la, want, out, got = _loss_and_grads(jmodel, params, jbatch, model, batch)
    assert abs(float(out["loss"].detach()) - la) <= 1e-4 * abs(la)
    for k, a in want.items():
        # a scale floor of 1e-3 as tests/test_torch_block_vjp.py: the k
        # MLPs' last biases have gradient 0 in exact arithmetic (~1e-11 here)
        scale = max(np.abs(a).max(), 1e-3)
        np.testing.assert_allclose(got[k], a, atol=GRAD_ATOL_SCALE * scale, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["V1", "V2", "time_simple"])
def test_two_sample_steps_match_jax(name):
    """Two ddpm steps (t = 6 -> 5 -> 4) fed JAX's own noise: positions,
    types (Gumbel margins > 1e-3) and the recon logits of each step."""
    jmodel, params, jbatch, model, batch = setup(OPTIONS[name])
    jcb, cbatch, lpos, lmask_f = _centered(jbatch, batch)
    C = jmodel.num_classes
    key = jax.random.PRNGKey(13)
    jpos, jv, pos, v = lpos, jbatch.ligand_v, torch.tensor(np.asarray(lpos)), batch.ligand_v
    for t in (6, 5):
        k_next, k_pos, k_v = jax.random.split(key, 3)
        noise = np.asarray(jax.random.normal(k_pos, lpos.shape, jnp.float32))
        uniform = np.asarray(jax.random.uniform(k_v, lpos.shape[:2] + (C,)))
        (jpos, jv, _), ys = jmodel._sample_step(
            params, jcb, lmask_f, jnp.zeros((2, 1, 3)), (jpos, jv, key),
            {"t": jnp.int32(t), "s": jnp.int32(t - 1)}, impl="xla", dtype=jnp.float32,
            pos_only=False, return_traj=False, return_v_probs=True)
        assert _gumbel_margin(uniform, ys["vt"]) > MARGIN
        pos, v, v0, _ = model.sample_step(cbatch, pos, v, t, torch.tensor(noise),
                                          torch.tensor(uniform), return_v_probs=True,
                                          impl="eager")
        np.testing.assert_allclose(_np(pos), np.asarray(jpos), atol=POS_ATOL)
        np.testing.assert_array_equal(_np(v), np.asarray(jv))
        np.testing.assert_allclose(_np(v0), np.asarray(ys["v0"]), **LOGIT_TOL)
        key = k_next


def test_likelihood_with_a_time_embedding_matches_jax():
    """V2 ('sin' time embedding): the step terms at t = 1 and T - 1 with
    JAX's draws; the embedding export passes no time step and refuses."""
    jmodel, params, jbatch, model, batch = setup(V2)
    t = np.array([1, jmodel.num_timesteps - 1])
    key = jax.random.PRNGKey(11)
    want = jmodel.likelihood_estimation(params, key, jbatch, jnp.asarray(t), impl="xla")
    key_pos, key_v = jax.random.split(key)
    noise = torch.tensor(np.asarray(jax.random.normal(key_pos, batch.ligand_pos.shape)))
    uniform = torch.tensor(np.asarray(jax.random.uniform(
        key_v, tuple(batch.ligand_v.shape) + (jmodel.num_classes,))))
    got = model.likelihood_estimation(batch, torch.from_numpy(t), pos_noise=noise,
                                      v_uniform=uniform)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=2e-4, rtol=2e-3)
    with pytest.raises(ValueError, match="time step"):
        model.fetch_embedding(batch)


@pytest.mark.parametrize("name", ["V1", "V2", "x2h_out_fc_no_norm", "time_simple"])
def test_bridge_round_trip_of_every_new_name(name):
    """flax -> state_dict -> flax is bit for bit the JAX tree, and the port
    carries the reference's names for each option."""
    _, params, _, model, _ = setup(OPTIONS[name])
    sd = model.net.state_dict()
    back = state_dict_to_flax_params(sd)["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.device_get(params["params"]))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.device_get(params["params"]))
    layer = "refine_net.base_block.1"
    want = {"V1": [f"{layer}.x2h_layers.0.ew_net.0.weight", f"{layer}.h2x_layers.0.ew_net.0.bias",
                   f"{layer}.x2h_layers.0.node_output.net.3.weight",
                   f"{layer}.x2h_layers.0.node_output.net.1.weight"],
            "V2": [f"{layer}.x2h_layers.1.ew_net.0.weight",
                   f"{layer}.h2x_layers.1.xv_func.net.2.bias",
                   f"{layer}.x2h_layers.1.hk_func.net.1.beta", "time_emb.1.weight",
                   "time_emb.3.bias"],
            "x2h_out_fc_no_norm": [f"{layer}.x2h_layers.0.node_output.net.2.weight"],
            "time_simple": ["ligand_atom_emb.weight"]}[name]
    assert set(want) <= set(sd)
    if name == "V2":
        assert not any("h2x_layers" in k and "ew_net" in k for k in sd)  # 'm': 1 in h2x
        assert "refine_net.edge_pred_layer.net.0.weight" not in sd
    if name == "time_simple":
        assert sd["ligand_atom_emb.weight"].shape[1] == NUM_CLASSES + 1


@pytest.mark.parametrize("name", list(OPTIONS))
def test_kernels_refuse_every_option(name):
    """The eager network builds each option; the kernel paths refuse it with
    its reason, and the model's path is 'eager'."""
    jmodel, params, jbatch, model, batch = setup(OPTIONS[name])
    cfg = model.config
    assert eager_supported(cfg) == (True, "")
    assert resolve_impl(cfg) == "eager"
    with pytest.raises(ValueError, match="impl='eager'"):
        require_kernels(cfg)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="impl='eager'"):
        model.fast_apply(batch, batch.ligand_pos, batch.ligand_v)
    with pytest.raises(ValueError, match="impl='eager'"):
        model.get_diffusion_loss(batch, generator=gen, impl="fast")
    with pytest.raises(ValueError, match="impl='eager'"):
        model.sample_diffusion(batch, batch.ligand_pos, batch.ligand_v, gen, num_steps=1,
                               impl="fast")


@pytest.mark.parametrize("override,reason", [
    (dict(cutoff_mode="radius"), "cutoff_mode"), (dict(num_r_gaussian=16), "fixed knots"),
    (dict(edge_feat_dim=8), "edge_feat_dim"), (dict(ew_net_type="x"), "ew_net_type"),
    (dict(act_fn="gelu"), "act_fn"), (dict(time_emb_dim=4, time_emb_mode="x"), "time_emb_mode")])
def test_eager_refusals_keep_their_reasons(override, reason):
    cfg = small_flagship()
    cfg.update(override)
    ok, why = eager_supported(cfg)
    assert not ok and reason in why


def test_variant_graph_is_one_knn_kernel_call_a_block(monkeypatch):
    """A variant's forward builds its kNN graph through the kNN kernel's
    wrapper (its plain version for CPU tensors here), once per block; the
    released float32 architecture keeps the plain graph, which the kernels
    are held against, and so does a hybrid variant."""
    calls = []
    wrapped = ut.knn_graph

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return wrapped(*a, **kw)

    monkeypatch.setattr(ut, "knn_graph", counting)
    for blocks in (1, 2):
        calls.clear()
        _, _, _, model, batch = setup(dict(V1, num_blocks=blocks))
        assert model.net.refine_net.knn_kernel
        with torch.no_grad():
            model.apply(batch, batch.ligand_pos, batch.ligand_v)
        assert len(calls) == blocks
    calls.clear()
    for overrides in ({}, dict(V1, cutoff_mode="hybrid")):
        _, _, _, model, batch = setup(overrides)
        with torch.no_grad():
            model.apply(batch, batch.ligand_pos, batch.ligand_v)
    assert calls == []
    assert not setup({})[3].net.refine_net.knn_kernel
    assert setup({}, model_dtype=torch.bfloat16)[3].net.refine_net.knn_kernel


def test_train_step_and_sampling_run_eagerly_on_v2():
    """The trainer's step and `sample_diffusion` (ddpm and dpm2, whose mid
    evaluation takes its own time step) on V2 through the normal entry
    points: finite losses, finite positions, types in the vocabulary."""
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.trainer import create_train_state, make_train_step
    from targetdiff_tpu_torch.utils import train as TU

    _, _, _, model, batch = setup(V2)
    opt = TU.get_optimizer(Config(type="adam", lr=5e-4, weight_decay=0.0, beta1=0.95,
                                  beta2=0.999, max_grad_norm=8.0), model.parameters())
    state = create_train_state(model, opt)
    step = make_train_step(model, pos_noise_std=0.1)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        state, metrics = step(state, batch, gen)
        assert np.isfinite(float(metrics["loss"]))
    assert state.step == 2
    for sampler in ("ddpm", "dpm2"):
        res = model.sample_diffusion(batch, batch.ligand_pos, batch.ligand_v, gen, num_steps=3,
                                     sampler=sampler)
        assert torch.isfinite(res.pos).all()
        assert bool(((res.v >= 0) & (res.v < NUM_CLASSES)).all())


# ---- the bf16 model ----------------------------------------------------------------

def _bf16_margins(got: dict, want: dict) -> list:
    return sorted(float(np.abs(got[k] - a).max() / max(np.abs(a).max(), 1e-8))
                  for k, a in want.items())


@pytest.mark.parametrize("name", ["V1", "V2", "released"])
def test_bf16_model_matches_jax_bf16(name):
    """`model_dtype=torch.bfloat16` against JAX's `dtype=jnp.bfloat16` model
    on its XLA path: positions, logits and final_h within 2e-2 of their
    scale, the loss within 1e-2 relative, the gradients' median tensor
    within BF16_GRAD_MEDIAN of its scale (the worst printed); parameters
    and gradients float32, the model eager even on the released
    architecture."""
    overrides = {} if name == "released" else OPTIONS[name]
    jmodel, params, jbatch, model, batch = setup(overrides, jnp.bfloat16, torch.bfloat16)
    assert model.impl == "eager" and model.model_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        assert model.net.embed(*batch, time_step=torch.from_numpy(T_STEPS))[0].dtype == \
            torch.bfloat16
    out, ref = _forward(jmodel, params, jbatch, model, batch)
    lmask = np.asarray(jbatch.ligand_mask)[..., None]
    for k, m in (("pred_ligand_pos", lmask), ("pred_ligand_v", lmask), ("final_h", 1.0)):
        a, b = _np(out[k]) * m, np.asarray(ref[k]).astype(np.float32) * m
        err = np.abs(a - b).max() / np.abs(b).max()
        print(f"{name} {k}: {err:.2e} of scale")
        assert out[k].dtype == torch.float32 and err <= BF16_BAR, (k, err)
    la, want, lout, got = _loss_and_grads(jmodel, params, jbatch, model, batch)
    margins = _bf16_margins(got, want)
    loss_rel = abs(float(lout["loss"].detach()) - la) / abs(la)
    print(f"{name} loss rel {loss_rel:.2e}; gradient median {np.median(margins):.2e}, "
          f"max {margins[-1]:.2e} of scale over {len(margins)} tensors")
    assert loss_rel <= BF16_LOSS_REL
    assert np.median(margins) <= BF16_GRAD_MEDIAN
    assert all(np.isfinite(g).all() and g.dtype == np.float32 for g in got.values())


def test_bf16_model_refuses_the_kernel_paths():
    """A bf16 model of the released architecture runs eagerly: the kernel
    paths take their precision from dtype=, never from the model."""
    _, _, _, model, batch = setup({}, model_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="model's dtype"):
        model.fast_apply(batch, batch.ligand_pos, batch.ligand_v)
    with pytest.raises(ValueError, match="model's dtype"):
        model.get_diffusion_loss(batch, generator=torch.Generator().manual_seed(0),
                                 impl="fast")


def test_train_cli_trains_the_bf16_model_of_v1_and_samples_from_it(tmp_path):
    """`train_diffusion --dtype bf16` on V1 builds the bf16 model and trains
    it eagerly (float32 checkpoint); the sampling CLI reads the checkpoint
    and samples the variant eagerly."""
    import os

    from targetdiff_tpu_torch.cli import sample_diffusion, train_diffusion
    from targetdiff_tpu_torch.utils.checkpoint import load_checkpoint
    from tests.test_torch_bf16_train import CLI_ARGS, _cli_config

    model_cfg = dict(small_flagship(), num_diffusion_timesteps=12, hidden_dim=16, knn=6,
                     num_layers=1, **V1)
    out = train_diffusion.main([_cli_config(tmp_path, model_cfg), "--logdir",
                                str(tmp_path / "logs"), *CLI_ARGS])
    log = open(os.path.join(out["log_dir"], "log.txt")).read()
    assert "training path: eager; model dtype: torch.bfloat16" in log
    assert np.isfinite(list(out["metrics"].values())).all()
    ck = out["checkpoints"][-1]
    with np.load(ck) as z:
        assert {z[k].dtype for k in z.files if z[k].dtype.kind == "f"} == {np.dtype(np.float32)}
    assert all(v.dtype == torch.float32 for v in load_checkpoint(ck)["state_dict"].values())
    yml = tmp_path / "sampling.yml"
    yml.write_text(f"model:\n  checkpoint: {ck}\nsample:\n  seed: 3\n  num_steps: 2\n"
                   "  num_samples: 2\n  sample_num_atoms: prior\n")
    res_dir = tmp_path / "out"
    sample_diffusion.main([str(yml), "-i", "0", "--result_path", str(res_dir),
                           "--max_ligand", "40", "--device", "cpu"])
    assert sorted(f.name for f in res_dir.glob("result_*.pkl")) == ["result_0.pkl"]


def test_sinusoidal_embedding_and_simple_feature_follow_jax():
    """The 'sin' features and the tanh GELU between the two Linears are
    JAX's (not nn.GELU()'s exact form); 'simple' appends t / T alone."""
    from targetdiff_tpu.models.score_model import SinusoidalPosEmb as JaxSin
    from targetdiff_tpu_torch.models.score_model import SinusoidalPosEmb

    t = np.array([0.0, 3.0, 999.0], np.float32)
    # arguments reach 999 rad, where one float32 ulp of a frequency moves
    # them by ~6e-5
    np.testing.assert_allclose(SinusoidalPosEmb(8)(torch.from_numpy(t)).numpy(),
                               np.asarray(JaxSin(8).apply({}, jnp.asarray(t))), atol=1e-4)
    _, _, _, model, _ = setup(OPTIONS["time_sin"])
    assert isinstance(model.net.time_emb[2], torch.nn.GELU)
    assert model.net.time_emb[2].approximate == "tanh"
    _, _, _, model, batch = setup(OPTIONS["time_simple"])
    feat = model.net.ligand_features(batch.ligand_v, torch.tensor([3, 7]))
    assert feat.shape[-1] == NUM_CLASSES + 1
    np.testing.assert_array_equal(feat[..., -1].numpy(), np.array([[0.3] * 8, [0.7] * 8],
                                                                  np.float32))
    with pytest.raises(ValueError, match="pass time_step"):
        model.net.ligand_features(batch.ligand_v)


@pytest.mark.parametrize("name", ["released", "V1"])
def test_float64_copy_of_a_float32_model_stays_float64(name):
    """A float64 copy of a float32 network (the float64 references the
    kernels are held against) computes in float64 throughout: the model
    dtype rounds nothing there, the h2x gate follows the positions."""
    import copy

    from targetdiff_tpu_torch.ops import graph as G
    from targetdiff_tpu_torch.ops.kernels import edge_layer as kel

    _, _, _, model, batch = setup({} if name == "released" else OPTIONS[name])
    with torch.no_grad():
        h, x, node_mask, mlig = model.net.embed(*batch)
        rn = copy.deepcopy(model.net.refine_net).double()
        h, x = h.double(), x.double()
        nbh = G.knn_graph(x, node_mask, rn.k)
        out_h, out_x = rn.block_forward(h, x, nbh, mlig)
        assert out_h.dtype == out_x.dtype == torch.float64
        if name == "released":
            e_w = rn.edge_weights(x, nbh)[..., 0]
            assert kel.x2h_layer_plain(rn.base_block[0], h, x, nbh, mlig, e_w).dtype == \
                torch.float64
            assert kel.h2x_layer_plain(rn.base_block[0], h, x, nbh, mlig, e_w).dtype == \
                torch.float64
