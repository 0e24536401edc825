"""Re-evaluate published meta files (TargetDiff / CVAE / AR / Pocket2Mol
results).

Usage: python -m targetdiff_tpu_torch.cli.evaluate_from_meta META_FILE
       [--eval_num_examples 100] [--docking_mode none] [--num_workers 8]

Counterpart of targetdiff_tpu/cli/evaluate_from_meta.py (reference:
scripts/evaluate_from_meta.py:39-138): loads a meta file (a torch .pt or a
pickle: one entry per pocket with pred_ligand_pos / pred_ligand_v lists),
scores each pocket's molecules with cli/evaluate_diffusion.evaluate_results
in a process pool and averages the validity and chemistry means over the
pockets. Docking needs the QVina and Vina programs: `--docking_mode`
accepts only `none`, as cli/evaluate_diffusion.py does.
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing
import os
import pickle
import tempfile
from functools import partial

import numpy as np

from .evaluate_diffusion import evaluate_results


def _load_meta(path):
    if path.endswith(".pt"):
        import torch

        return torch.load(path, map_location="cpu", weights_only=False)
    with open(path, "rb") as f:
        return pickle.load(f)


def _eval_pocket(entry, atom_mode):
    """The evaluation summary of one pocket's samples (an entry of the meta
    file)."""
    res = {
        "pred_ligand_pos": [np.asarray(p) for p in entry["pred_ligand_pos"]],
        "pred_ligand_v": [np.asarray(v) for v in entry["pred_ligand_v"]],
        "data": entry.get("data", {}),
        "ligand_atom_mode": atom_mode,
    }
    with tempfile.TemporaryDirectory() as d:
        fp = os.path.join(d, "result_0.pkl")
        with open(fp, "wb") as f:
            pickle.dump(res, f)
        summary, _ = evaluate_results([fp], atom_mode)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("meta_file")
    ap.add_argument("--eval_num_examples", type=int, default=None)
    ap.add_argument("--docking_mode", default="none", choices=["none"],
                    help="docking needs the QVina / Vina programs; only 'none' is accepted")
    ap.add_argument("--atom_mode", default="add_aromatic")
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    logger = logging.getLogger("eval_meta")
    meta = _load_meta(args.meta_file)
    if isinstance(meta, dict):
        meta = [meta]
    if args.eval_num_examples:
        meta = meta[: args.eval_num_examples]
    logger.info(f"{len(meta)} pockets")

    fn = partial(_eval_pocket, atom_mode=args.atom_mode)
    if args.num_workers > 1:
        with multiprocessing.get_context("spawn").Pool(args.num_workers) as pool:
            summaries = pool.map(fn, meta)
    else:
        summaries = [fn(m) for m in meta]

    # averaged over pockets
    agg = {}
    for s in summaries:
        for k, val in s["validity"].items():
            agg.setdefault(k, []).append(val)
        for k in ("qed_mean", "sa_mean"):
            if s.get(k) is not None:
                agg.setdefault(k, []).append(s[k])
    final = {k: float(np.mean(v)) for k, v in agg.items()}
    for k, v in final.items():
        logger.info(f"{k}: {v:.4f}")
    out = args.out or args.meta_file + ".metrics.pkl"
    with open(out, "wb") as f:
        pickle.dump({"per_pocket": summaries, "aggregate": final}, f)
    logger.info(f"saved {out}")


if __name__ == "__main__":
    main()
