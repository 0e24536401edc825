"""The paper-style summary table of evaluation outputs.

Usage: python -m targetdiff_tpu_torch.cli.summarize_results metrics.pkl [...]
       [--ref_vina_pkl TESTSET_DOCKING.pkl]

Counterpart of targetdiff_tpu/cli/summarize_results.py (reference:
notebooks/summary.ipynb, print_results / compute_high_affinity): per metrics
file, the mean / median of QED and SA, diversity, size, the Vina scores
where the results have them with the high-affinity share against the
reference ligands, and the numeric fields of the summary. Reads the
metrics.pkl that cli/evaluate_diffusion.py writes.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Dict, List, Optional

import numpy as np


def agg(vals: List[float]) -> str:
    if not vals:
        return "-"
    return f"{np.mean(vals):.3f} / {np.median(vals):.3f}"


def summarize(metrics_path: str, ref_vina: Optional[Dict[str, float]] = None) -> Dict:
    with open(metrics_path, "rb") as f:
        data = pickle.load(f)
    results = data.get("results", [])
    summary = dict(data.get("summary", {}))

    qed = [r["chem_results"]["qed"] for r in results]
    sa = [r["chem_results"]["sa"] for r in results]
    sizes = [len(r["v"]) for r in results if "v" in r]
    smiles = [r["smiles"] for r in results]
    diversity = len(set(smiles)) / max(len(smiles), 1)

    table = {
        "QED (mean/med)": agg(qed),
        "SA (mean/med)": agg(sa),
        "Diversity": f"{diversity:.3f}",
        "Size (mean)": f"{np.mean(sizes):.1f}" if sizes else "-",
        "N results": len(results),
    }
    for key in ("score", "minimize", "dock", "qvina"):
        vals = [r["vina"][key] for r in results
                if r.get("vina") and r["vina"].get(key) is not None]
        if vals:
            table[f"Vina {key} (mean/med)"] = agg(vals)
            if ref_vina and key in ref_vina:
                # high affinity: better (lower) than the reference ligand
                ha = np.mean([v < ref_vina[key] for v in vals])
                table[f"High-affinity % ({key})"] = f"{100 * ha:.1f}"
    table.update({k: v for k, v in summary.items()
                  if isinstance(v, (int, float)) and v is not None})
    return table


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("metrics", nargs="+")
    ap.add_argument("--ref_vina_pkl", default=None,
                    help="test-set docking results for the high-affinity %%")
    args = ap.parse_args(argv)

    ref_vina = None
    if args.ref_vina_pkl:
        with open(args.ref_vina_pkl, "rb") as f:
            raw = pickle.load(f)
        vals = [r["vina"][0]["affinity"] for r in raw if r.get("vina")]
        ref_vina = {"dock": float(np.median(vals))} if vals else None

    for path in args.metrics:
        print(f"== {path} ==")
        for k, v in summarize(path, ref_vina).items():
            print(f"  {k:32s} {v}")


if __name__ == "__main__":
    main()
