"""Evaluate sampling results: stability, reconstruction, chemistry and the
JSD metrics, written to metrics.pkl.

Usage: python -m targetdiff_tpu_torch.cli.evaluate_diffusion OUTPUT_DIR
       [--atom_mode MODE] [--eval_num_examples N] [--eval_step STEP]

Counterpart of targetdiff_tpu/cli/evaluate_diffusion.py (reference:
scripts/evaluate_diffusion.py:35-208), with the same summary and the same
per-molecule results. Per sample: stability (analyze.check_stability), pair
distances, reconstruction, completeness, QED/SA/logP/Lipinski. Docking needs
the QVina and Vina programs: `--docking_mode` accepts only `none`.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import pickle
from collections import Counter

import numpy as np

from ..chem.reconstruct import MolReconsError, reconstruct_from_generated
from ..data.transforms import get_atomic_number_from_index, is_aromatic_from_index
from ..evaluation import analyze, eval_atom_type, eval_bond_length
from ..evaluation.scoring import get_chem


def evaluate_results(result_files, atom_mode, logger=None, eval_step=-1):
    """(summary, results) of the molecules in `result_files` (result_*.pkl
    of cli/sample_diffusion). `eval_step` indexes a saved trajectory
    (reference: evaluate_diffusion.py:76); -1, the final step, also works on
    results saved without one. Only MolReconsError counts as a failed
    reconstruction; any other exception propagates."""
    log = logger or logging.getLogger("eval")
    n_samples = 0
    n_stable = 0
    n_atom_stable, n_atom_total = 0, 0
    n_recon, n_complete = 0, 0
    n_arom_pred, n_arom_recovered = 0, 0
    all_pair_dist, all_bond_dist = [], []
    all_atom_types = Counter()
    results = []

    for fpath in result_files:
        with open(fpath, "rb") as f:
            res = pickle.load(f)
        if eval_step == -1 or "pred_ligand_pos_traj" not in res:
            if eval_step != -1:
                raise SystemExit(f"--eval_step {eval_step} needs trajectories; {fpath} has none")
            pos_list, v_list = res["pred_ligand_pos"], res["pred_ligand_v"]
        else:
            pos_list = [t[eval_step] for t in res["pred_ligand_pos_traj"]]
            v_list = [t[eval_step] for t in res["pred_ligand_v_traj"]]
        for pos, v in zip(pos_list, v_list):
            n_samples += 1
            atom_nums = get_atomic_number_from_index(v, atom_mode)
            aromatic = is_aromatic_from_index(v, atom_mode)

            stable, ns, na = analyze.check_stability(pos, atom_nums)
            n_stable += int(stable)
            n_atom_stable += ns
            n_atom_total += na
            all_atom_types += Counter(atom_nums)
            all_pair_dist += eval_bond_length.pair_distance_from_pos_v(pos, atom_nums)

            # aromatic-ring recovery: of the samples whose type channel
            # predicts an aromatic system (>= 5 aromatic-class atoms), the
            # share that reconstructs to a molecule with an aromatic ring
            arom_predicted = aromatic is not None and sum(aromatic) >= 5

            try:
                mol = reconstruct_from_generated(
                    pos, atom_nums, aromatic, basic_mode=(atom_mode == "basic"))
                smiles = mol.to_smiles()
            except MolReconsError:
                if arom_predicted:
                    n_arom_pred += 1
                continue
            n_recon += 1
            if arom_predicted:
                n_arom_pred += 1
                n_arom_recovered += int(any(b.aromatic for b in mol.bonds))
            if "." in smiles:
                continue
            n_complete += 1
            all_bond_dist += eval_bond_length.bond_distance_from_mol(mol)
            try:
                chem = get_chem(mol)
            except Exception as e:
                log.info(f"chem scoring failed: {e}")
                continue
            results.append({"smiles": smiles, "chem_results": chem, "mol": mol,
                            "pos": pos, "v": v})

    validity = {
        "mol_stable": n_stable / max(n_samples, 1),
        "atm_stable": n_atom_stable / max(n_atom_total, 1),
        "recon_success": n_recon / max(n_samples, 1),
        "completeness": n_complete / max(n_samples, 1),
    }
    bond_profile = eval_bond_length.get_bond_length_profile(all_bond_dist)
    bond_metrics = eval_bond_length.eval_bond_length_profile(bond_profile)
    pair_profile = eval_bond_length.get_pair_length_profile(all_pair_dist)
    pair_metrics = eval_bond_length.eval_pair_length_profile(pair_profile)
    atom_jsd = eval_atom_type.eval_atom_type_distribution(all_atom_types)

    qed = [r["chem_results"]["qed"] for r in results]
    sa = [r["chem_results"]["sa"] for r in results]
    summary = {
        "validity": validity,
        "bond_length_jsd": bond_metrics,
        "pair_length_jsd": pair_metrics,
        "atom_type_jsd": atom_jsd,
        # raw profiles, so that callers (tools/quality_gate.py) can compare
        # against a distribution other than the frozen CrossDocked tables
        "pair_length_profile": pair_profile,
        "bond_length_profile": bond_profile,
        "bond_type_counts": Counter(
            eval_bond_length._format_bond_type(bt) for bt, _ in all_bond_dist),
        "atom_type_counts": all_atom_types,
        "aromatic_ring_recovery": n_arom_recovered / n_arom_pred if n_arom_pred else None,
        "n_aromatic_predicted": n_arom_pred,
        "qed_mean": float(np.mean(qed)) if qed else None,
        "qed_median": float(np.median(qed)) if qed else None,
        "sa_mean": float(np.mean(sa)) if sa else None,
        "sa_median": float(np.median(sa)) if sa else None,
        "num_results": len(results),
    }
    ring_sizes = Counter()
    for r in results:
        ring_sizes += Counter(r["chem_results"]["ring_size"])
    total_rings = sum(ring_sizes.values())
    summary["ring_size_ratio"] = {k: v / max(total_rings, 1)
                                  for k, v in sorted(ring_sizes.items())}
    return summary, results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sample_path")
    ap.add_argument("--docking_mode", default="none", choices=["none"],
                    help="docking needs the QVina / Vina programs; only 'none' is accepted")
    ap.add_argument("--atom_mode", default=None,
                    help="override ligand atom mode (else read from results)")
    ap.add_argument("--eval_num_examples", type=int, default=None,
                    help="evaluate only the first N result files "
                    "(reference: evaluate_diffusion.py:40)")
    ap.add_argument("--eval_step", type=int, default=-1,
                    help="trajectory step to evaluate (needs results with trajectories "
                    "unless -1; reference: evaluate_diffusion.py:39)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    logger = logging.getLogger("evaluate")
    files = sorted(glob.glob(os.path.join(args.sample_path, "result_*.pkl")))
    if not files:
        raise SystemExit(f"no result_*.pkl under {args.sample_path}")
    if args.eval_num_examples is not None:
        files = files[: args.eval_num_examples]
    with open(files[0], "rb") as f:
        first = pickle.load(f)
    atom_mode = args.atom_mode or first.get("ligand_atom_mode", "add_aromatic")

    summary, results = evaluate_results(files, atom_mode, logger=logger,
                                        eval_step=args.eval_step)
    for k, v in summary.items():
        if not k.endswith("_profile"):  # raw histograms, too long for the log
            logger.info(f"{k}: {v}")
    out_path = args.out or os.path.join(args.sample_path, "metrics.pkl")
    with open(out_path, "wb") as f:
        pickle.dump({"summary": summary,
                     "results": [{k: v for k, v in r.items() if k != "mol"} for r in results]},
                    f)
    logger.info(f"saved {out_path}")


if __name__ == "__main__":
    main()
