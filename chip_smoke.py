#!/usr/bin/env python3
"""Smoke run of the PyTorch port (targetdiff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from targetdiff_tpu_torch/csrc, holds each kernel
against its plain PyTorch version at the main path's shapes (the example
pocket: 572 atoms padded to 576, 32 ligand slots, K = 32, four complexes;
flagship width: 9 layers, hidden 128, 16 heads), then samples molecules for
that pocket through the port's entry point `sample_diffusion_ligand` with
seeded random flagship weights, and checks the outputs. Then the training
path: the train-mode block kernel and the block-VJP kernel against autograd
of the plain block, the whole loss and its gradients on the kernel path
against the eager path, `make_train_step` at the bench's train shape (B=32,
384-slot synthetic pockets), a short fit, and the train CLI's `run` on a
six-entry dataset, whose checkpoint is reloaded and sampled from. Every
phase prints one line; any failure exits non-zero. The last two lines are a
JSON record of the kernels and the contract line {"ok": true, "device": {...}}.

Needs a CUDA device and the CUDA toolkit (nvcc); there is no CPU path.
"""

from __future__ import annotations

import json
import logging
import pickle
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
POCKET_PDB = REPO / "examples" / "1h36_A_rec_1h36_r88_lig_tt_docked_0_pocket10.pdb"
LIGAND_SDF = REPO / "examples" / "3ug2_ligand.sdf"

# the released TargetDiff architecture (configs/training.yml `model`)
FLAGSHIP = dict(
    model_mean_type="C0", beta_schedule="sigmoid", beta_start=1e-7, beta_end=2e-3,
    v_beta_schedule="cosine", v_beta_s=0.01, num_diffusion_timesteps=1000,
    loss_v_weight=100.0, sample_time_method="symmetric", time_emb_dim=0,
    time_emb_mode="simple", center_pos_mode="protein", node_indicator=True,
    model_type="uni_o2", num_blocks=1, num_layers=9, hidden_dim=128, n_heads=16,
    edge_feat_dim=4, num_r_gaussian=20, knn=32, num_node_types=8, act_fn="relu",
    norm=True, cutoff_mode="knn", ew_net_type="global", num_x2h=1, num_h2x=1,
    r_max=10.0, x2h_out_fc=False, sync_twoup=False,
)
NUM_CLASSES = 13  # add_aromatic ligand vocabulary
B, MAX_PROTEIN, MAX_LIGAND, K = 4, 576, 32, 32
LIGAND_SIZES = [32, 27, 21, 14]  # ligand atoms per complex in the parity phases
KNN_RTOL = 1e-4
POS_TOL = dict(atol=2e-4, rtol=1e-3)
H_TOL = dict(atol=2e-3, rtol=1e-2)
GRAD_ATOL_SCALE, GRAD_RTOL = 5e-3, 5e-3  # atol = 5e-3 * max|plain grad| per tensor
OPTIMIZER = dict(type="adam", lr=5e-4, weight_decay=0.0, beta1=0.95, beta2=0.999,
                 max_grad_norm=8.0)
TRAIN_B, TRAIN_PROTEIN, TRAIN_VALID, TRAIN_STEPS, TRAIN_WARMUP = 32, 384, 330, 20, 3


def phase(label: str, **fields) -> None:
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_close(name, got, want, atol, rtol) -> float:
    """Raise unless |got - want| <= atol + rtol |want|; return max |got - want|."""
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: {int(bad.sum())} entries outside atol={atol} "
                             f"rtol={rtol}; max abs err {float(err.max())}")
    return float(err.max())


def check_grads(got: dict, want: dict) -> float:
    """Every gradient within GRAD_ATOL_SCALE * max|want| + GRAD_RTOL |want|;
    returns the largest error relative to its tensor's scale. The k
    second-layer biases have zero gradient in exact arithmetic (softmax shift
    invariance): theirs are float32 noise, held to 1e-5 of the largest grad."""
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        if name.endswith("k_func.net.3.bias"):
            if float(g.abs().max()) > 1e-5 * top:
                raise AssertionError(f"{name}: {float(g.abs().max())} not ~0")
            continue
        scale = float(w.abs().max())
        err = check_close(name, g, w, GRAD_ATOL_SCALE * scale, GRAD_RTOL)
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def loss_draws(torch, model, batch, gen):
    """Timesteps, position noise and categorical uniforms for a batch."""
    dev = batch.ligand_pos.device
    t = torch.randint(0, model.num_timesteps, (batch.num_graphs,), generator=gen, device=dev)
    eps = torch.randn(batch.ligand_pos.shape, generator=gen, device=dev)
    u = torch.rand(batch.ligand_v.shape + (NUM_CLASSES,), generator=gen, device=dev)
    return t, eps, u


def loss_vs_eager(torch, model, batch, t, eps, u, label) -> dict:
    """get_diffusion_loss and every parameter gradient on the kernel path
    against the eager path, same draws: loss within relative 1e-4, grads to
    `check_grads`. Returns the phase's fields."""
    out = {}
    for impl in ("fast", "eager"):
        model.net.zero_grad(set_to_none=True)
        loss = model.get_diffusion_loss(batch, time_step=t, pos_noise=eps, v_uniform=u,
                                        impl=impl)["loss"]
        loss.backward()
        out[impl] = (float(loss.detach()), {n: p.grad for n, p in model.net.named_parameters()})
    model.net.zero_grad(set_to_none=True)
    loss_rel = abs(out["fast"][0] - out["eager"][0]) / abs(out["eager"][0])
    if not loss_rel < 1e-4:
        raise AssertionError(f"{label}: relative loss error {loss_rel}")
    return dict(loss=out["fast"][0], loss_eager=out["eager"][0], rel_err=loss_rel,
                max_grad_err_over_scale=check_grads(out["fast"][1], out["eager"][1]),
                params=len(out["fast"][1]))


def main() -> int:
    if not (REPO / "targetdiff_tpu_torch").is_dir() or not POCKET_PDB.is_file():
        raise RuntimeError(f"chip_smoke.py runs from a checkout of the repository; {REPO} "
                           "lacks targetdiff_tpu_torch/ or the example pocket")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device: torch.cuda.is_available() is False")
    sys.path.insert(0, str(REPO))
    from targetdiff_tpu_torch.cli.sample_for_pocket import pdb_to_pocket_data, reconstruct_all
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.data.batch import ComplexBatch
    from targetdiff_tpu_torch.data.transforms import FeaturizeProteinAtom
    from targetdiff_tpu_torch.models.score_model import DiffusionModel
    from targetdiff_tpu_torch.ops import graph as G
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import build
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand

    # 1. device
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    print(card, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    log = (build.build_dir() / "build.log").read_text().splitlines()
    ptxas = [ln.strip() for ln in log if "registers" in ln or "spill" in ln]
    phase("build", seconds=build_s, dir=build.build_dir().relative_to(REPO))
    for ln in ptxas:
        print("  ptxas:", ln, flush=True)

    # inputs at the main path's shapes: the example pocket, centred, with
    # ligands at the pocket centre plus unit noise
    feat = FeaturizeProteinAtom()
    data = pdb_to_pocket_data(str(POCKET_PDB), feat)
    pocket = {"protein_pos": data["protein_pos"], "protein_feat": data["protein_atom_feature"]}
    n_prot = len(pocket["protein_pos"])
    gen = torch.Generator(device=dev).manual_seed(0)
    ppos = torch.zeros((B, MAX_PROTEIN, 3), device=dev)
    pfeat = torch.zeros((B, MAX_PROTEIN, feat.feature_dim), device=dev)
    ppos[:, :n_prot] = torch.as_tensor(pocket["protein_pos"], dtype=torch.float32, device=dev)
    pfeat[:, :n_prot] = torch.as_tensor(pocket["protein_feat"], device=dev)
    pmask = torch.zeros((B, MAX_PROTEIN), dtype=torch.bool, device=dev)
    pmask[:, :n_prot] = True
    com = ppos[:, :n_prot].mean(1, keepdim=True)
    ppos = torch.where(pmask[..., None], ppos - com, 0.0)
    lpos = torch.randn((B, MAX_LIGAND, 3), generator=gen, device=dev)
    lmask = torch.arange(MAX_LIGAND, device=dev)[None] < torch.tensor(LIGAND_SIZES, device=dev)[:, None]
    lv = torch.randint(0, NUM_CLASSES, (B, MAX_LIGAND), generator=gen, device=dev)

    torch.manual_seed(0)
    model = DiffusionModel(Config(FLAGSHIP), feat.feature_dim, NUM_CLASSES, device=dev,
                           max_protein=MAX_PROTEIN, max_ligand=MAX_LIGAND)
    rn = model.net.refine_net
    with torch.no_grad():
        h, x, node_mask, mask_ligand = model.net.embed(ppos, pfeat, pmask, lpos, lv, lmask)
    N = x.shape[1]

    # 3. kNN kernel against the plain version (tie-tolerant)
    plain_nbh = G.knn_graph(x, node_mask, K)
    nbh = kknn.knn_graph_cuda(x, node_mask, K)
    torch.cuda.synchronize()
    if not torch.equal(nbh.mask, plain_nbh.mask):
        raise AssertionError("knn: neighbour masks differ from the plain version")
    if not bool(((nbh.idx >= 0) & (nbh.idx < N)).all()):
        raise AssertionError("knn: an index lies outside [0, N)")
    x64 = x.double()

    def chosen_d2(idx):
        return ((x64[:, :, None] - G.gather_nodes(x64, idx)) ** 2).sum(-1)

    d2_k = torch.where(nbh.mask, chosen_d2(nbh.idx), 0.0)
    d2_p = torch.where(plain_nbh.mask, chosen_d2(plain_nbh.idx), 0.0)
    kth_k, kth_p = d2_k.amax(-1), d2_p.amax(-1)
    knn_err = float((kth_k - kth_p).abs().max())
    tol = KNN_RTOL * kth_p + 1e-6
    if bool(((kth_k - kth_p).abs() > tol).any()) or bool((d2_k > (kth_p + tol)[..., None]).any()):
        raise AssertionError(f"knn: K-th distances disagree (max abs err {knn_err})")
    same = float((nbh.idx == plain_nbh.idx)[nbh.mask].float().mean())
    knn_ms = cuda_ms(torch, lambda: kknn.knn_graph_cuda(x, node_mask, K))
    knn_plain_ms = cuda_ms(torch, lambda: G.knn_graph(x, node_mask, K))
    phase("knn", shape=f"B={B},N={N},K={K}", max_abs_err_kth_d2=knn_err,
          same_index_fraction=same, ms=knn_ms, plain_ms=knn_plain_ms)

    # 4. block kernels against the plain block, f32, flagship width
    packed = kblock.pack_block_params(rn)
    with torch.no_grad():
        h_p, x_p = rn.block_forward(h, x, plain_nbh, mask_ligand)
        h_k, x_k = kblock.block_denoiser_cuda(rn, h, x, plain_nbh, mask_ligand, MAX_LIGAND, packed)
    torch.cuda.synchronize()
    lig = mask_ligand
    x_err = check_close("block x (ligand rows)", x_k[lig], x_p[lig], **POS_TOL)
    h_err = check_close("block h (ligand rows)", h_k[lig], h_p[lig], **H_TOL)
    h_err_all = float((h_k - h_p).abs()[node_mask].max())
    moved = float((x_k - x).abs()[lig].max())
    if moved < 1e-3:
        raise AssertionError(f"block: ligand positions did not move ({moved})")
    with torch.no_grad():
        block_ms = cuda_ms(torch, lambda: kblock.block_denoiser_cuda(
            rn, h, x, plain_nbh, mask_ligand, MAX_LIGAND, packed), reps=10)
        block_plain_ms = cuda_ms(torch, lambda: rn.block_forward(h, x, plain_nbh, mask_ligand),
                                 reps=10)
    phase("block", shape=f"B={B},N={N},K={K},L={FLAGSHIP['num_layers']},H=128,heads=16",
          max_abs_err_x=x_err, max_abs_err_h=h_err, max_abs_err_h_valid_rows=h_err_all,
          ms=block_ms, plain_ms=block_plain_ms)

    # whole forward: kernel-backed against eager, same inputs
    batch = ComplexBatch(ppos, pfeat, pmask, lpos, lv, lmask)
    with torch.no_grad():
        fk = model.fast_apply(batch, lpos, lv, packed=packed)
        fp = model.apply(batch, lpos, lv)
    lm = lmask[..., None].expand(-1, -1, 3)
    fwd_pos_err = check_close("forward pos", fk["pred_ligand_pos"][lm], fp["pred_ligand_pos"][lm],
                              **POS_TOL)
    lmv = lmask[..., None].expand(-1, -1, NUM_CLASSES)
    fwd_v_err = check_close("forward logits", fk["pred_ligand_v"][lmv], fp["pred_ligand_v"][lmv],
                            **H_TOL)
    phase("forward", max_abs_err_pos=fwd_pos_err, max_abs_err_logits=fwd_v_err)

    # 5. sample through the port's entry point
    steps = model.num_timesteps
    kknn.LAUNCHES = 0
    kblock.LAUNCHES = 0
    t0 = time.perf_counter()
    res = sample_diffusion_ligand(
        model, pocket, num_samples=B, generator=torch.Generator(device=dev).manual_seed(2),
        batch_size=B, num_steps=steps, max_protein=MAX_PROTEIN, max_ligand=MAX_LIGAND,
        rng=np.random.default_rng(2))
    wall = time.perf_counter() - t0
    knn_launches, block_launches = kknn.LAUNCHES, kblock.LAUNCHES
    if knn_launches == 0 or block_launches == 0:
        raise AssertionError(f"sampling did not launch the kernels (knn {knn_launches}, "
                             f"block {block_launches})")
    for pos, v in zip(res["pos"], res["v"]):
        if pos.shape != (len(v), 3) or not np.isfinite(pos).all():
            raise AssertionError("sampling produced a non-finite or misshaped molecule")
        if not ((v >= 0) & (v < NUM_CLASSES)).all():
            raise AssertionError("sampling produced an atom type outside the vocabulary")
    sizes = [len(v) for v in res["v"]]
    dist = float(max(np.linalg.norm(p.mean(0) - pocket["protein_pos"].mean(0)) for p in res["pos"]))
    sdf = REPO / "outputs" / "chip_smoke_samples.sdf"
    sdf.parent.mkdir(exist_ok=True)
    sdf.unlink(missing_ok=True)
    rebuilt = reconstruct_all(res["pos"], res["v"], "add_aromatic", str(sdf),
                              logging.getLogger("chip_smoke"))
    sample_s = res["time"][0]
    phase("sample", samples=B, steps=steps, ligand_atoms=sizes, seconds=sample_s,
          wall_seconds=wall, ms_per_step=1e3 * sample_s / steps, mol_per_s=B / sample_s,
          knn_launches=knn_launches, block_launches=block_launches,
          max_centroid_offset_A=dist, reconstructed=f"{len(rebuilt)}/{B}")

    train = train_phases(torch, dev, model, rn, h, x, plain_nbh, mask_ligand, node_mask, batch,
                         pocket, feat)

    print(json.dumps({"kernels": [
        {"name": "knn_graph", "route": "cuda", "source": "targetdiff_tpu_torch/csrc/knn.cu",
         "replaces": "targetdiff_tpu/ops/pallas/knn.py:27", "launches": knn_launches,
         "max_abs_err": knn_err, "ms": knn_ms, "plain_ms": knn_plain_ms},
        {"name": "block_denoiser", "route": "cuda",
         "source": "targetdiff_tpu_torch/csrc/block_denoiser.cu",
         "replaces": "targetdiff_tpu/ops/pallas/block_denoiser.py:154",
         "launches": block_launches, "max_abs_err": max(x_err, h_err), "ms": block_ms,
         "plain_ms": block_plain_ms},
        {"name": "block_denoiser_train", "route": "cuda",
         "source": "targetdiff_tpu_torch/csrc/block_denoiser.cu",
         "replaces": "targetdiff_tpu/ops/pallas/block_denoiser.py:154", **train["fwd"]},
        {"name": "block_vjp", "route": "cuda", "source": "targetdiff_tpu_torch/csrc/block_vjp.cu",
         "replaces": "targetdiff_tpu/ops/pallas/block_vjp.py:113", **train["bwd"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def train_phases(torch, dev, model, rn, h, x, nbh, mask_ligand, node_mask, batch, pocket, feat):
    """[train-block], [train-loss], [train], [train-cli]. Returns the two
    training kernels' JSON fields."""
    from targetdiff_tpu_torch.cli import train_diffusion
    from targetdiff_tpu_torch.config import Config
    from targetdiff_tpu_torch.data.datasets import PaddedLoader, get_dataset
    from targetdiff_tpu_torch.data.synth import synth_batch
    from targetdiff_tpu_torch.models.score_model import DiffusionModel
    from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
    from targetdiff_tpu_torch.ops.kernels import block_vjp as kvjp
    from targetdiff_tpu_torch.ops.kernels import knn as kknn
    from targetdiff_tpu_torch.sampling import sample_diffusion_ligand
    from targetdiff_tpu_torch.trainer import create_train_state, make_eval_step, make_train_step
    from targetdiff_tpu_torch.utils import train as train_utils
    from targetdiff_tpu_torch.utils.port import flax_params_to_state_dict, load_npz_params

    # ---- [train-block]: train-mode forward and backward kernels vs the plain block ----
    with torch.no_grad():
        e_w = rn.edge_weights(x, nbh)[..., 0]
        x2h, h2x = kblock.pack_pass_params(rn)
    gen = torch.Generator(device=dev).manual_seed(5)
    gh = torch.randn(h.shape, generator=gen, device=dev)
    gx = torch.randn(x.shape, generator=gen, device=dev)
    # checkpoints [L+1,B,N,.]: slot 0 the input, slot L the block's output
    want = kblock.block_denoiser_train_plain(rn, h, x, nbh, mask_ligand, e_w)
    with torch.no_grad():
        hck_k, xck_k = kblock.block_denoiser_train_cuda(rn, h, x, nbh, mask_ligand, e_w,
                                                        MAX_LIGAND, x2h, h2x)
    torch.cuda.synchronize()
    ck = node_mask[None, :, :, None]
    fwd_err = max(check_close("train fwd hck", hck_k * ck, want[0] * ck, **H_TOL),
                  check_close("train fwd xck", xck_k * ck, want[1] * ck, **POS_TOL))

    def fwd_bwd(trainable):
        leaves = [t.clone().requires_grad_() for t in (h, x, e_w)]
        rn.zero_grad(set_to_none=True)
        if trainable:
            ho, xo = kvjp.block_layers_trainable(rn, leaves[0], leaves[1], nbh, mask_ligand,
                                                 leaves[2], MAX_LIGAND)
        else:
            ho, xo = rn.block_forward(leaves[0], leaves[1], nbh, mask_ligand, e_w=leaves[2])
        ((ho * gh).sum() + (xo * gx).sum()).backward()
        grads = {n: p.grad for n, p in rn.named_parameters() if p.grad is not None}
        grads.update(dh0=leaves[0].grad, dx0=leaves[1].grad, de_w=leaves[2].grad)
        return grads

    g_k, g_p = fwd_bwd(True), fwd_bwd(False)
    torch.cuda.synchronize()
    if sorted(g_k) != sorted(g_p):
        raise AssertionError("train-block: the kernel path reached other parameters")
    bwd_rel = check_grads(g_k, g_p)
    bwd_err = max(float((g_k[n] - g_p[n]).abs().max()) for n in ("dh0", "dx0", "de_w"))
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: kblock.block_denoiser_train_cuda(
            rn, h, x, nbh, mask_ligand, e_w, MAX_LIGAND, x2h, h2x), reps=10)
        fwd_plain_ms = cuda_ms(torch, lambda: kblock.block_denoiser_train_plain(
            rn, h, x, nbh, mask_ligand, e_w), reps=10)
        bwd_ms = cuda_ms(torch, lambda: kvjp.block_bwd_cuda(
            hck_k, xck_k, nbh.idx, nbh.mask, mask_ligand, e_w, MAX_LIGAND, x2h, h2x, gh, gx),
            reps=10)
    # the plain backward alone: autograd through one recorded graph of the
    # plain block, to h, x, e_w and the parameters the block uses
    leaves = [t.clone().requires_grad_() for t in (h, x, e_w)]
    outs = rn.block_forward(leaves[0], leaves[1], nbh, mask_ligand, e_w=leaves[2])
    wrt = leaves + [p for n, p in rn.named_parameters() if n in g_p]
    bwd_plain_ms = cuda_ms(torch, lambda: torch.autograd.grad(outs, wrt, (gh, gx),
                                                              retain_graph=True), reps=10)
    del outs
    step_ms = cuda_ms(torch, lambda: fwd_bwd(True), reps=10)
    step_plain_ms = cuda_ms(torch, lambda: fwd_bwd(False), reps=10)
    phase("train-block", shape=f"B={B},N={h.shape[1]},K={K},L={FLAGSHIP['num_layers']}",
          max_abs_err_fwd=fwd_err, max_abs_err_dh_dx_dew=bwd_err, max_grad_err_over_scale=bwd_rel,
          fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms, bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
          fwd_bwd_ms=step_ms, fwd_bwd_plain_ms=step_plain_ms)

    # ---- [train-loss]: the whole loss, kernel path vs eager path, injected draws ----
    t, eps, u = loss_draws(torch, model, batch, gen)
    phase("train-loss", **loss_vs_eager(torch, model, batch, t, eps, u, "train-loss"))

    # ---- [train]: make_train_step at the bench's train shape ----
    tb = synth_batch(np.random.default_rng(3), TRAIN_B, max_protein=TRAIN_PROTEIN,
                     max_ligand=MAX_LIGAND, n_protein_range=(TRAIN_VALID, TRAIN_VALID + 1),
                     n_ligand_range=(18, 28), device=dev)
    torch.manual_seed(1)
    tmodel = DiffusionModel(Config(FLAGSHIP), feat.feature_dim, NUM_CLASSES, device=dev,
                            max_protein=TRAIN_PROTEIN, max_ligand=MAX_LIGAND)
    state = create_train_state(tmodel, train_utils.get_optimizer(Config(OPTIMIZER),
                                                                 tmodel.parameters()))
    step = make_train_step(tmodel, pos_noise_std=0.1, time_sampling="importance")
    # the loss and every gradient at this shape, kernel path against eager
    torch.cuda.reset_peak_memory_stats()
    parity = loss_vs_eager(torch, tmodel, tb, *loss_draws(torch, tmodel, tb, gen), "train")
    parity_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    tgen = torch.Generator(device=dev).manual_seed(0)
    before = [p.detach().clone() for p in tmodel.parameters()]
    kknn.LAUNCHES = kblock.LAUNCHES = kblock.TRAIN_LAUNCHES = kvjp.LAUNCHES = 0
    for _ in range(TRAIN_WARMUP):
        state, metrics = step(state, tb, tgen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, tb, tgen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"knn": kknn.LAUNCHES, "train_fwd": kblock.TRAIN_LAUNCHES, "vjp": kvjp.LAUNCHES}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    m = {k: float(v) for k, v in metrics.items()}
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    if not all(np.isfinite(v) for v in m.values()) or not (m["loss"] > 0 and m["grad_norm"] > 0):
        raise AssertionError(f"train: bad metrics {m}")
    if launches["vjp"] != n_steps or launches["train_fwd"] != n_steps or launches["knn"] != n_steps:
        raise AssertionError(f"train: expected one launch of each kernel per step, {launches}")
    moved = max(float((p.detach() - b).abs().max()) for p, b in zip(tmodel.parameters(), before))
    if not moved > 0:
        raise AssertionError("train: the parameters did not move")
    ms_step = 1e3 * train_s / TRAIN_STEPS
    # a 10-step fit of one fixed batch with fixed draws must lower its loss
    fit_losses = []
    for _ in range(10):
        state, fm = step(state, batch, None, time_step=t, pos_noise=eps, v_uniform=u)
        fit_losses.append(float(fm["loss"]))
    if not fit_losses[-1] < fit_losses[0]:
        raise AssertionError(f"train: a 10-step fit did not lower the loss {fit_losses}")
    phase("train", shape=f"B={TRAIN_B},N={TRAIN_PROTEIN + MAX_LIGAND},K={K},valid={TRAIN_VALID}",
          steps=TRAIN_STEPS, ms_per_step=ms_step, complexes_per_s=TRAIN_B * 1e3 / ms_step,
          peak_mem_gib=peak_gib, loss=m["loss"], grad_norm=m["grad_norm"], launches=launches,
          fit_first=fit_losses[0], fit_last=fit_losses[-1], parity_loss_rel_err=parity["rel_err"],
          parity_max_grad_err_over_scale=parity["max_grad_err_over_scale"],
          parity_peak_mem_gib=parity_peak_gib)
    train_launches = dict(launches)

    # ---- [train-cli]: the train CLI's run on a six-entry dataset, reload, sample ----
    root = REPO / "outputs" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    (root / "raw").mkdir(parents=True)
    shutil.copyfile(POCKET_PDB, root / "raw" / "pocket.pdb")
    shutil.copyfile(LIGAND_SDF, root / "raw" / "ligand.sdf")
    with open(root / "raw" / "index.pkl", "wb") as f:
        pickle.dump([("pocket.pdb", "ligand.sdf", 0.5)] * 6, f)
    torch.save({"train": [0, 1, 2, 3], "test": [4, 5]}, root / "split.pt")
    config = Config(
        data=dict(name="pl", path=str(root / "raw"), split=str(root / "split.pt"),
                  transform=dict(ligand_atom_mode="add_aromatic", random_rot=False)),
        model=FLAGSHIP,
        train=dict(seed=1, batch_size=4, max_iters=4, val_freq=2, pos_noise_std=0.1,
                   max_grad_norm=8.0, optimizer={k: v for k, v in OPTIMIZER.items()
                                                 if k != "max_grad_norm"},
                   scheduler=dict(type="plateau", factor=0.6, patience=10, min_lr=1e-6)))
    args = train_diffusion.parser().parse_args(
        ["in-code", "--device", "cuda", "--logdir", str(root / "logs"), "--max_protein",
         str(MAX_PROTEIN), "--max_ligand", "40", "--train_report_iter", "1"])
    # the CLI's checkpoint writer, wrapped to keep the params it was handed
    written = {}
    save_checkpoint = train_diffusion.save_checkpoint

    def save_and_keep(path, cfg, net, *rest):
        written[path] = {k: v.detach().clone() for k, v in net.state_dict().items()}
        return save_checkpoint(path, cfg, net, *rest)

    kknn.LAUNCHES = kblock.LAUNCHES = kblock.TRAIN_LAUNCHES = kvjp.LAUNCHES = 0
    train_diffusion.save_checkpoint = save_and_keep
    try:
        res = train_diffusion.run(config, args)
    finally:
        train_diffusion.save_checkpoint = save_checkpoint
    cli_launches = {"train_fwd": kblock.TRAIN_LAUNCHES, "vjp": kvjp.LAUNCHES}
    if (not res["checkpoints"] or sorted(written) != sorted(res["checkpoints"])
            or cli_launches["vjp"] != config.train.max_iters):
        raise AssertionError(f"train-cli: checkpoints {res['checkpoints']}, "
                             f"launches {cli_launches}")
    # every checkpoint reloads equal to the params it was written from
    for ckpt in res["checkpoints"]:
        reloaded = DiffusionModel(Config(FLAGSHIP), feat.feature_dim, NUM_CLASSES, device=dev,
                                  max_protein=MAX_PROTEIN, max_ligand=40)
        reloaded.net.load_state_dict(flax_params_to_state_dict(load_npz_params(ckpt)))
        state_dict = reloaded.net.state_dict()
        if sorted(state_dict) != sorted(written[ckpt]) or not all(
                torch.equal(v, written[ckpt][k]) for k, v in state_dict.items()):
            raise AssertionError(f"train-cli: {ckpt} does not reload to the params it saved")
    ck_iter = int(Path(ckpt).stem.split("_")[-1])
    # the reloaded params give exactly the best validation loss the run logged
    transform = train_diffusion.build_transform(config.data, 1)[0]
    val_set = get_dataset(config.data, transform)[1]["test"]
    val_loader = PaddedLoader(val_set, 4, MAX_PROTEIN, 40, shuffle=False, drop_last=False,
                              device=dev)
    val = train_diffusion.validate(reloaded, make_eval_step(reloaded), val_loader, 1,
                                   logging.getLogger("chip_smoke"), ck_iter)
    if abs(val - res["best_val"]) > 1e-6 * abs(res["best_val"]):
        raise AssertionError(f"train-cli: reloaded val loss {val} != logged {res['best_val']}")
    kknn.LAUNCHES = kblock.LAUNCHES = 0
    sres = sample_diffusion_ligand(
        reloaded, pocket, num_samples=B, generator=torch.Generator(device=dev).manual_seed(4),
        batch_size=B, num_steps=10, max_protein=MAX_PROTEIN, max_ligand=40,
        rng=np.random.default_rng(4))
    if kknn.LAUNCHES < 10 or kblock.LAUNCHES < 10:
        raise AssertionError("train-cli: sampling from the checkpoint did not launch the kernels")
    if not all(np.isfinite(p).all() for p in sres["pos"]):
        raise AssertionError("train-cli: sampling from the checkpoint gave non-finite positions")
    phase("train-cli", checkpoints=[Path(c).name for c in res["checkpoints"]],
          best_val=res["best_val"], reloaded_val=val,
          reloaded_equal_saved=f"{len(written)}/{len(res['checkpoints'])}",
          launches=cli_launches, sample_launches=kblock.LAUNCHES)

    return {"fwd": {"launches": train_launches["train_fwd"], "max_abs_err": fwd_err,
                    "ms": fwd_ms, "plain_ms": fwd_plain_ms},
            "bwd": {"launches": train_launches["vjp"], "max_abs_err": bwd_err, "ms": bwd_ms,
                    "plain_ms": bwd_plain_ms}}


if __name__ == "__main__":
    sys.exit(main())
