"""Speed and quality of the strided samplers against 1000-step DDPM, on a
model trained in the port: counterpart of tools/ddim_eval.py.

Trains the flagship on the synthetic corpus with the quality gate's recipe
(tools/quality_gate.py), then samples the same trained weights with each of
ROWS through `sampling.sample_testset` and scores every set with the gate's
`evaluate`:

  ddpm-1000        the reference's ancestral sampler (the baseline)
  ddpm-100-trunc   the reference's only faster option: the last 100 steps of
                   the schedule (truncation, molopt_score_model.py:649)
  ddim-*           the whole schedule strided over 100 or 50 jumps, uniform
                   or quadratic spacing, eta 0 or 1
  dpm2-*           the Heun correction of the ddim jump, two network
                   evaluations a jump

Each row reports the gate's metrics, its seconds and molecules per second
(host clock around the sampling call) and the network evaluations (NFE) of
one run with the milliseconds per evaluation of a sampling chunk. `checks`
holds the claim: ddim-100 keeps the atom stability of ddpm-1000 within
DDIM_ATOM_STABLE_DROP, and truncation loses at least TRUNC_ATOM_STABLE_GAP
of it against ddim-100.

Usage: python -m targetdiff_tpu_torch.tools.ddim_eval [train_steps] [n_mols]
       [out.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..models.score_model import sampling_schedule
from . import quality_gate as qg

# the rows of tools/ddim_eval.py, with its settings
ROWS = [
    ("ddpm-1000", dict(num_steps=1000, sampler="ddpm")),
    ("ddpm-100-trunc", dict(num_steps=100, sampler="ddpm")),
    ("ddim-100", dict(num_steps=100, sampler="ddim", eta=0.0)),
    ("ddim-50", dict(num_steps=50, sampler="ddim", eta=0.0)),
    ("ddim-100-quad", dict(num_steps=100, sampler="ddim", eta=0.0, ddim_spacing="quadratic")),
    ("ddim-50-quad", dict(num_steps=50, sampler="ddim", eta=0.0, ddim_spacing="quadratic")),
    ("ddim-100-quad-eta1", dict(num_steps=100, sampler="ddim", eta=1.0,
                                ddim_spacing="quadratic")),
    ("dpm2-50", dict(num_steps=50, sampler="dpm2", eta=0.0)),
    ("dpm2-50-quad", dict(num_steps=50, sampler="dpm2", eta=0.0, ddim_spacing="quadratic")),
    ("dpm2-25", dict(num_steps=25, sampler="dpm2", eta=0.0)),
]
DDIM_ATOM_STABLE_DROP = 0.10
TRUNC_ATOM_STABLE_GAP = 0.30


def nfe(num_timesteps: int, num_steps: int, sampler: str = "ddpm",
        ddim_spacing: str = "uniform", **_) -> int:
    """Network evaluations of one run: one a jump, two for dpm2 but on the
    final jump, where `sample_step` skips the correction."""
    jumps = len(sampling_schedule(num_timesteps, num_steps, sampler, ddim_spacing)[0])
    return 2 * jumps - 1 if sampler == "dpm2" else jumps


def run(steps: int, n_mols: int, device="cuda", rows=ROWS, n_pockets=32, pool_size=1024,
        corpus_n=256, log=print, **model_overrides) -> dict:
    """Train `steps` steps, then sample and score `n_mols` molecules for
    each of `rows`. Returns {row name: metrics} plus 'train', the loss curve
    and train seconds."""
    model = qg.build_model(device, **model_overrides)
    pool = qg.make_pool(pool=pool_size)
    prof = qg.train_profile(pool, corpus_n)
    log(f"training {steps} steps...")
    qg._sync(device)
    t0 = time.perf_counter()
    _, trained, loss_hist = qg.train(model, pool, steps, log=log)
    qg._sync(device)
    report = {"train": {"steps": steps, "seconds": time.perf_counter() - t0,
                        "loss_hist": loss_hist}}
    chunks = -(-(n_pockets * -(-n_mols // n_pockets)) // qg.CHUNK_ROWS)
    for name, kw in rows:
        log(f"sampling {name}...")
        t0 = time.perf_counter()
        mols, sample_s = qg.sample(model, trained, pool, n_mols, n_pockets=n_pockets, **kw)
        dt = time.perf_counter() - t0
        ev = qg.evaluate(mols, prof)
        n_eval = nfe(model.num_timesteps, **kw)
        ev.update(sample_seconds=dt, mols_per_sec=n_mols / dt, nfe=n_eval,
                  ms_per_nfe=1e3 * sample_s / (chunks * n_eval), chunks=chunks)
        report[name] = ev
        log(f"  {name}: {dt:.1f}s  mol_stable={ev['mol_stable']:.3f} "
            f"atom_stable={ev['atom_stable']:.3f} recon={ev['recon_success']:.3f}")
    return report


def checks(report: dict) -> dict:
    """The claim of the table, as named booleans (a missing row fails)."""
    missing = [name for name, _ in ROWS if name not in report]
    if missing:
        return {"rows_complete": False}
    ddpm, trunc, ddim = (report[k]["atom_stable"] for k in ("ddpm-1000", "ddpm-100-trunc",
                                                            "ddim-100"))
    return {"rows_complete": True,
            "ddim_keeps_atom_stability": ddim >= ddpm - DDIM_ATOM_STABLE_DROP,
            "truncation_collapses": trunc <= ddim - TRUNC_ATOM_STABLE_GAP}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", nargs="?", type=int, default=4000)
    ap.add_argument("n_mols", nargs="?", type=int, default=128)
    ap.add_argument("out", nargs="?", default="ddim_eval_torch.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = run(args.steps, args.n_mols, args.device)
    report["checks"] = checks(report)
    report["device"] = (torch.cuda.get_device_name(args.device)
                        if torch.device(args.device).type == "cuda" else args.device)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    failed = [k for k, ok in report["checks"].items() if not ok]
    print("DDIM", "FAIL: " + ", ".join(failed) if failed else "ok")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
