"""Correlate diffusion-derived likelihood features with binding affinity.

Usage: python -m targetdiff_tpu_torch.cli.analyze_affinity likelihood/crossdocked_test.pkl \
       --affinity_pkl affinity_info.pkl

Counterpart of targetdiff_tpu/cli/analyze_affinity.py (reference:
notebooks/analyze_affinity.ipynb): loads the likelihood export
(cli/likelihood_est_diffusion.py), computes per-complex features (nll, the
mean entropy of the predicted atom types, the mean norm of the ligand's
hidden states) and prints their Pearson and Spearman correlations with the
measured pK, the paper's unsupervised affinity ranking. Host code: numpy,
pickle and scipy.stats.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def entropy_of(pred_v: np.ndarray) -> float:
    p = np.clip(pred_v, 1e-12, 1.0)
    return float(-(p * np.log(p)).sum(-1).mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("likelihood_pkl")
    ap.add_argument("--affinity_pkl", default=None,
                    help="pickle {ligand_filename: pk}; else uses 'pk' entries")
    args = ap.parse_args(argv)

    from scipy import stats

    with open(args.likelihood_pkl, "rb") as f:
        entries = pickle.load(f)
    pk_map = None
    if args.affinity_pkl:
        with open(args.affinity_pkl, "rb") as f:
            pk_map = pickle.load(f)

    feats, pks = [], []
    for e in entries:
        pk = e.get("pk") if pk_map is None else pk_map.get(e["ligand_filename"])
        if pk is None or pk <= 0:
            continue
        feats.append({
            "nll": e["nll"],
            "entropy": entropy_of(np.asarray(e["pred_ligand_v"])),
            "h_norm": float(np.linalg.norm(e["final_ligand_h"], axis=-1).mean()),
        })
        pks.append(float(pk))

    if len(pks) < 3:
        raise SystemExit("not enough complexes with affinity labels")
    pks = np.asarray(pks)
    print(f"{len(pks)} complexes")
    for key in ("nll", "entropy", "h_norm"):
        x = np.asarray([f[key] for f in feats])
        pear = stats.pearsonr(x, pks)[0]
        spear = stats.spearmanr(x, pks)[0]
        print(f"{key:10s} pearson {pear:+.3f}  spearman {spear:+.3f}")


if __name__ == "__main__":
    main()
