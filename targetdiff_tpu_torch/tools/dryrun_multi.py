"""Data-parallel dry run on W processes: the port's counterpart of
__graft_entry__.dryrun_multichip (data parallel only).

    python -m targetdiff_tpu_torch.tools.dryrun_multi [--world 2]
        [--device cuda|cpu] [--backend gloo|nccl] [--small]

The parent runs the flagship (uni_o2, 9 layers, hidden 128, 16 heads, K =
32; seeded random weights) in one process: `sample_testset` of 8 rows (a
synthetic pocket, or the caller's) for 20 DDPM steps, then one `make_train_step`
of the B = 32 train leg (330-atom synthetic pockets in 384 slots, 32
ligand slots: N = 416) with protein noise and importance time sampling.
Then W spawned ranks of one process group (`parallel.mesh.run_ranks`) run
the same two things data parallel: the sampling with each chunk's rows
split, the step with B / W complexes a rank and the gradients all-reduced.
Each rank's result is held against the parent's: the molecules
(`SAMPLE_TOL`, types equal, identical on every rank) and the step's loss,
gradients, gradient norm, updated parameters and Lt EMA (the constants
below); the gradients both against the whole batch's and against the
mean of the same row shards' gradients taken in the parent, which
isolates the collective from the order in which the kernels sum a
batch's rows. Each rank also reports its kernel launches, its ms per step
(on the card also its device ms per step, by torch.profiler) and per
sampling step (after a warm-up run), the ms of its forward and backward
alone and of `all_reduce_grads` alone, with the gradient buffer's bytes. --small runs a
2-layer, hidden-32, K = 8 model at B = 4 (the CPU tests' size). Prints
`dryrun_multi ok: dp=W loss=...`; a mismatch, a rank that fails or a time
out raises. The command prints the report as one JSON line last.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..data.synth import synth_batch
from ..models.score_model import DiffusionModel
from ..parallel import mesh as pmesh
from ..sampling import sample_testset
from ..trainer import create_train_state, make_train_step, step_inputs
from ..utils.train import get_optimizer
from .quality_gate import FLAGSHIP, NUM_CLASSES, OPTIMIZER, PROTEIN_FEAT_DIM

# what the ranks are held to against one process (the step's draws are the
# same; only the rows per call, and so the order of sums, differ)
LOSS_REL = 1e-6  # loss, relative
GRAD_BAR = 1e-5  # every all-reduced gradient entry against the mean of the same row
# shards' gradients taken in one process, relative to max |g|: the collective is exact
WHOLE_GRAD_BAR = 5e-3  # ... against the whole batch's: each tensor within this of its
# own max |g| plus this of |g|. The block backward sums a batch's rows in another order at
# another batch size, so these are two float32 computations of one gradient, held as
# chip_smoke.py's check_grads holds the kernels' gradients to eager: the k second-layer
# biases, zero in exact arithmetic (softmax shift invariance), are float32 noise there and
# held to ZERO_GRAD_BAR of max |g|
ZERO_GRAD_BAR = 1e-5
ZERO_GRAD = "k_func.net.3.bias"
NORM_REL = 1e-5  # the gradient norm before clipping, relative
PARAM_ABS = 1e-6  # updated parameters where |g| > PARAM_G_FLOOR * max |g|
PARAM_G_FLOOR = 1e-3  # Adam's first step is ~lr * sign(g): a near-zero g may flip by 2 lr
LT_REL = 1e-5  # the Lt EMA, relative to its largest entry
SAMPLE_TOL = dict(atol=1e-5, rtol=0.0)  # positions; types are held equal

FULL = dict(model={}, train_b=32, train_protein=384, train_valid=330, max_ligand=32,
            ligand_atoms=(18, 28), sample_rows=8, sample_steps=20, timed_steps=5)
SMALL = dict(model=dict(num_layers=2, hidden_dim=32, n_heads=4, knn=8,
                        num_diffusion_timesteps=20),
             train_b=4, train_protein=40, train_valid=32, max_ligand=8, ligand_atoms=(4, 8),
             sample_rows=6, sample_steps=4, timed_steps=1)
SEED = 1


def build(size: dict, device, max_protein: int) -> DiffusionModel:
    torch.manual_seed(SEED)
    return DiffusionModel(Config(dict(FLAGSHIP, **size["model"])), PROTEIN_FEAT_DIM,
                          NUM_CLASSES, device=device, max_protein=max_protein,
                          max_ligand=size["max_ligand"])


def train_batch(size: dict, device):
    return synth_batch(np.random.default_rng(3), size["train_b"],
                       max_protein=size["train_protein"], max_ligand=size["max_ligand"],
                       n_protein_range=(size["train_valid"], size["train_valid"] + 1),
                       n_ligand_range=size["ligand_atoms"],
                       device=device)


def default_pocket(size: dict) -> dict:
    b = train_batch(size, "cpu")
    n = int(b.protein_mask[0].sum())
    return {"protein_pos": b.protein_pos[0, :n].numpy(),
            "protein_feat": b.protein_feat[0, :n].numpy()}


def launches() -> Dict[str, int]:
    """The kernel counts of this process (kNN, inference block in float32
    and in bf16, the sampling default, the sampler's dependency cone,
    train-mode block, block backward)."""
    from ..ops.kernels import block_denoiser as kblock
    from ..ops.kernels import block_vjp
    from ..ops.kernels import cone as kcone
    from ..ops.kernels import knn as kknn

    return {"knn": kknn.LAUNCHES, "block": kblock.LAUNCHES, "block_bf16": kblock.BF16_LAUNCHES,
            "cone": kcone.LAUNCHES, "block_train": kblock.TRAIN_LAUNCHES,
            "block_vjp": block_vjp.LAUNCHES}


def reset_launches() -> None:
    from ..ops.kernels import block_denoiser as kblock
    from ..ops.kernels import block_vjp
    from ..ops.kernels import cone as kcone
    from ..ops.kernels import knn as kknn

    kknn.LAUNCHES = kblock.LAUNCHES = kblock.TRAIN_LAUNCHES = block_vjp.LAUNCHES = 0
    kblock.BF16_LAUNCHES = kcone.LAUNCHES = 0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sample_leg(size: dict, pocket: dict, device, world: int, mesh=None) -> dict:
    """`sample_testset` of the leg's rows for the pocket, seeded weights, in
    chunks of the rows rounded down to a multiple of `world` (as a mesh of
    `world` ranks rounds them, so one process draws what the ranks draw)."""
    max_protein = -(-len(pocket["protein_pos"]) // 64) * 64
    model = build(size, device, max_protein)

    def sample():
        return sample_testset(model, [pocket], size["sample_rows"],
                              torch.Generator(device=device).manual_seed(2),
                              num_steps=size["sample_steps"], max_protein=max_protein,
                              rng=np.random.default_rng(2),
                              chunk_rows=max(world, size["sample_rows"] // world * world),
                              mesh=mesh)[0]

    sample()  # warm-up: the first call's library and handle set-up is not a step's
    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    res = sample()
    seconds = time.perf_counter() - t0
    return {"pos": res["pos"], "v": res["v"], "launches": launches(),
            "ms_per_step": 1e3 * seconds / size["sample_steps"]}


def train_leg(size: dict, device, mesh=None) -> dict:
    """One train step of the leg from seeded weights: its metrics, the
    gradients it applied, the updated parameters and Lt EMA; then the ms of
    `timed_steps` more steps."""
    model = build(size, device, size["train_protein"])
    state = create_train_state(model, get_optimizer(Config(OPTIMIZER), model.parameters()))
    if mesh is not None:
        pmesh.replicate_state(model.net, state.optimizer, mesh)
    step = make_train_step(model, pos_noise_std=0.1, time_sampling="importance", mesh=mesh)
    batch, gen = train_batch(size, device), torch.Generator(device=device).manual_seed(0)
    reset_launches()
    state, metrics = step(state, batch, gen)
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "launches": launches(),
           "grads": {n: p.grad.detach().cpu().clone() for n, p in model.net.named_parameters()
                     if p.grad is not None},
           "params": {n: p.detach().cpu().clone() for n, p in model.net.named_parameters()},
           "Lt_history": state.Lt_history.cpu().clone()}
    sync(device)
    t0 = time.perf_counter()
    for _ in range(size["timed_steps"]):
        state, metrics = step(state, batch, gen)
    sync(device)
    out["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / size["timed_steps"]
    if torch.device(device).type == "cuda":
        out["device_ms_per_step"] = device_ms(lambda: step(state, batch, gen),
                                              size["timed_steps"])
    if mesh is not None:
        out.update(rank_costs(model, batch, gen, mesh, size["timed_steps"]))
    return out


def device_ms(fn, calls: int) -> float:
    """Device milliseconds per call of fn: every kernel and copy it puts on
    the card, summed by torch.profiler over `calls` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)) / 1e3 / calls


def rank_costs(model, batch, gen, mesh, reps: int) -> dict:
    """This rank's forward and backward alone on its rows, and
    `all_reduce_grads` alone on the step's gradients (ms each, the buffer's
    bytes)."""
    local = pmesh.shard_rows(batch, mesh)

    def fwd_bwd():
        model.net.zero_grad()
        model.get_diffusion_loss(local, generator=gen)["loss"].backward()

    fwd_bwd()
    sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fwd_bwd()
    sync(mesh.device)
    compute_ms = 1e3 * (time.perf_counter() - t0) / reps
    pmesh.barrier(mesh)
    sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        nbytes = pmesh.all_reduce_grads(model.parameters(), mesh)
    sync(mesh.device)
    return {"fwd_bwd_ms": compute_ms, "all_reduce_ms": 1e3 * (time.perf_counter() - t0) / reps,
            "all_reduce_bytes": nbytes}


def rank_job(mesh, size: dict, pocket: dict) -> dict:
    """One rank of the dry run: the sampling leg, then the train leg."""
    return {"sample": sample_leg(size, pocket, mesh.device, mesh.world, mesh),
            "train": train_leg(size, mesh.device, mesh)}


def compare_sample(got: dict, want: dict) -> float:
    """Largest position difference; raises if a molecule's size or types
    differ or a position is out of SAMPLE_TOL."""
    err = 0.0
    for i, (gp, gv, wp, wv) in enumerate(zip(got["pos"], got["v"], want["pos"], want["v"])):
        if gp.shape != wp.shape or not np.array_equal(gv, wv):
            raise AssertionError(f"dryrun_multi: molecule {i} differs in size or types")
        np.testing.assert_allclose(gp, wp, **SAMPLE_TOL, err_msg=f"molecule {i} positions")
        err = max(err, float(np.abs(gp - wp).max()))
    if len(got["pos"]) != len(want["pos"]):
        raise AssertionError("dryrun_multi: a different number of molecules")
    return err


def shard_grads(size: dict, device, world: int) -> Dict[str, torch.Tensor]:
    """What the ranks' all-reduce must give: the mean of the gradients of
    the train leg's `world` row shards, each taken in this process with its
    slice of the step's draws (`trainer.step_inputs`)."""
    model = build(size, device, size["train_protein"])
    state = create_train_state(model, get_optimizer(Config(OPTIMIZER), model.parameters()))
    batch, *draws = step_inputs(model, state, train_batch(size, device),
                                torch.Generator(device=device).manual_seed(0), 0.1, "importance")
    model.train()
    for r in range(world):
        mesh = pmesh.Mesh(r, world, torch.device(device))
        start, stop = pmesh.row_range(batch.num_graphs, mesh)
        model.get_diffusion_loss(pmesh.shard_rows(batch, mesh),
                                 *[d[start:stop] for d in draws])["loss"].backward()
    return {n: p.grad.detach().cpu() / world for n, p in model.net.named_parameters()
            if p.grad is not None}


def compare_train(got: dict, want: dict, shards: Dict[str, torch.Tensor]) -> dict:
    """The rank's step against the one-process step and its gradients also
    against the one-process mean of the shards' (`shard_grads`), each at
    its bar; returns the errors."""
    gm, wm = got["metrics"], want["metrics"]
    loss_rel = abs(gm["loss"] - wm["loss"]) / abs(wm["loss"])
    norm_rel = abs(gm["grad_norm"] - wm["grad_norm"]) / abs(wm["grad_norm"])
    if not got["grads"].keys() == want["grads"].keys() == shards.keys():
        raise AssertionError("dryrun_multi: the ranks' gradients cover other parameters")
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    whole_err, whole_ok, zero_err, worst = 0.0, True, 0.0, {}
    for n, g in want["grads"].items():
        if n.endswith(ZERO_GRAD):
            zero_err = max(zero_err, float(got["grads"][n].abs().max()) / gmax)
            continue
        diff, scale = (got["grads"][n] - g).abs(), float(g.abs().max())
        whole_ok &= bool((diff <= WHOLE_GRAD_BAR * (scale + g.abs())).all())
        worst[n] = float(diff.max()) / max(scale, 1e-30)
        whole_err = max(whole_err, worst[n])
    grad_err = max(float((got["grads"][n] - g).abs().max()) for n, g in shards.items())
    param_err = 0.0
    for n, p in want["params"].items():
        g = want["grads"].get(n)
        sel = (g.abs() > PARAM_G_FLOOR * gmax) if g is not None else torch.ones_like(p, dtype=bool)
        if bool(sel.any()):
            param_err = max(param_err, float((got["params"][n] - p).abs()[sel].max()))
    lt_scale = float(want["Lt_history"].abs().max())
    lt_rel = float((got["Lt_history"] - want["Lt_history"]).abs().max()) / lt_scale
    errs = {"loss_rel": loss_rel, "grad_over_max": grad_err / gmax,
            "whole_grad_over_scale": whole_err, "zero_grad_over_max": zero_err,
            "grad_norm_rel": norm_rel, "param_abs": param_err, "Lt_rel": lt_rel,
            "whole_worst": dict(sorted(worst.items(), key=lambda kv: -kv[1])[:3])}
    bars = {"loss_rel": LOSS_REL, "grad_over_max": GRAD_BAR, "zero_grad_over_max":
            ZERO_GRAD_BAR, "grad_norm_rel": NORM_REL, "param_abs": PARAM_ABS, "Lt_rel": LT_REL}
    missed = {k: (errs[k], bars[k]) for k in bars if not errs[k] <= bars[k]}
    if not whole_ok:
        missed["whole_grad_over_scale"] = (whole_err, WHOLE_GRAD_BAR)
    if missed:
        raise AssertionError(f"dryrun_multi: the data-parallel step misses (error, bar): "
                             f"{missed}; {errs}")
    return errs


def run(world: int = 2, device: str = "cuda", backend: str = "gloo",
        small: bool = False, pocket: Optional[dict] = None, timeout_s: float = 600.0,
        threads: Optional[int] = None) -> dict:
    """The dry run (module docstring). Returns the one-process figures, each
    rank's figures and errors, and the gradient buffer's bytes."""
    size = copy.deepcopy(SMALL if small else FULL)
    pocket = pocket or default_pocket(size)
    dev = pmesh.rank_device(device, 0)
    if dev.type == "cuda":  # build the kernels once, before the ranks start
        from ..ops.kernels import build

        build.load_library()
    ref = {"sample": sample_leg(size, pocket, dev, world), "train": train_leg(size, dev),
           "shard_grads": shard_grads(size, dev, world)}
    ranks = pmesh.run_ranks(rank_job, world, device, backend, args=(size, pocket),
                            timeout_s=timeout_s, threads=threads)
    report = {"world": world, "device": str(dev), "backend": backend, "one_process": {
                  "sample_ms_per_step": ref["sample"]["ms_per_step"],
                  "train_ms_per_step": ref["train"]["ms_per_step"],
                  "train_device_ms_per_step": ref["train"].get("device_ms_per_step"),
                  "loss": ref["train"]["metrics"]["loss"],
                  "sample_launches": ref["sample"]["launches"],
                  "train_launches": ref["train"]["launches"]}, "ranks": []}
    for r, out in enumerate(ranks):
        s, t = out["sample"], out["train"]
        if r and not all(np.array_equal(a, b) for a, b in zip(s["pos"], ranks[0]["sample"]["pos"])):
            raise AssertionError(f"dryrun_multi: rank {r}'s molecules differ from rank 0's")
        if r and not all(torch.equal(p, ranks[0]["train"]["params"][n])
                         for n, p in t["params"].items()):
            raise AssertionError(f"dryrun_multi: rank {r}'s parameters differ from rank 0's")
        report["ranks"].append({
            "sample_pos_err": compare_sample(s, ref["sample"]),
            "sample_ms_per_step": s["ms_per_step"], "sample_launches": s["launches"],
            "train_errs": compare_train(t, ref["train"], ref["shard_grads"]),
            "loss": t["metrics"]["loss"],
            "train_ms_per_step": t["ms_per_step"], "train_launches": t["launches"],
            "train_device_ms_per_step": t.get("device_ms_per_step"),
            **{k: t[k] for k in ("fwd_bwd_ms", "all_reduce_ms", "all_reduce_bytes")}})
    print(f"dryrun_multi ok: dp={world} loss={report['ranks'][0]['loss']:.6f} "
          f"(one process {report['one_process']['loss']:.6f})", flush=True)
    return report


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="gloo", choices=list(pmesh.BACKENDS),
                    help="nccl needs a card a rank")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    report = run(args.world, args.device, args.backend, args.small)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
