#!/usr/bin/env python3
"""Smoke run of the PyTorch port (targetdiff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from targetdiff_tpu_torch/csrc, holds each kernel
against its plain PyTorch version at the main path's shapes (the example
pocket: 572 atoms padded to 576, 32 ligand slots, K = 32, four complexes;
flagship width: 9 layers, hidden 128, 16 heads), then samples molecules for
that pocket through the port's entry point `sample_diffusion_ligand` with
seeded random flagship weights, and checks the outputs. Every phase prints
one line; any failure exits non-zero. The last two lines are a JSON record
of the kernels and the contract line {"ok": true, "device": {...}}.

Needs a CUDA device and the CUDA toolkit (nvcc); there is no CPU path.
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
POCKET_PDB = REPO / "examples" / "1h36_A_rec_1h36_r88_lig_tt_docked_0_pocket10.pdb"

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

    print(json.dumps({"kernels": [
        {"name": "knn_graph", "route": "cuda", "source": "targetdiff_tpu_torch/csrc/knn.cu",
         "replaces": "targetdiff_tpu/ops/pallas/knn.py:27", "launches": knn_launches,
         "max_abs_err": knn_err, "ms": knn_ms, "plain_ms": knn_plain_ms},
        {"name": "block_denoiser", "route": "cuda",
         "source": "targetdiff_tpu_torch/csrc/block_denoiser.cu",
         "replaces": "targetdiff_tpu/ops/pallas/block_denoiser.py:154",
         "launches": block_launches, "max_abs_err": max(x_err, h_err), "ms": block_ms,
         "plain_ms": block_plain_ms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
