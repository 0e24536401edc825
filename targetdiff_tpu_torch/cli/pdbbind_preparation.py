"""PDBBind preparation: index parsing, pocket extraction, splits.
Counterpart of targetdiff_tpu/cli/pdbbind_preparation.py, with the same
outputs on the same inputs.

Subcommands (counterparts of reference
scripts/property_prediction/extract_pockets.py:16-39 and pdbbind_split.py:9-38):
  pockets — parse the PDBBind index (INDEX_general_PL_data / refined), extract
            10A pockets around each ligand, emit index.pkl with pK + kind
  split   — core-set (CASF) test split or random split

Usage: python -m targetdiff_tpu_torch.cli.pdbbind_preparation {pockets,split} ...
"""

from __future__ import annotations

import argparse
import os
import pickle
import re
from multiprocessing import Pool

KMAP = {"Ki": 1, "Kd": 2, "IC50": 3}


def parse_pdbbind_data_index(path: str):
    """Parse INDEX_general_PL_data.YYYY lines:
    pdbid resolution year -logKd/Ki value // reference ligand-name."""
    entries = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            fields = line.split()
            pdbid, pk = fields[0], float(fields[3])
            m = re.match(r"(Ki|Kd|IC50)[=<>~]", fields[4])
            kind = KMAP[m.group(1)] if m else 0
            entries.append({"pdbid": pdbid, "pk": pk, "kind": kind})
    return entries


def _extract_one(task):
    from ..chem.pdb import PDBProtein
    from ..chem.sdf import parse_sdf_file

    root, dest, entry, radius = task
    pdbid = entry["pdbid"]
    try:
        protein_path = os.path.join(root, pdbid, f"{pdbid}_protein.pdb")
        ligand_path = os.path.join(root, pdbid, f"{pdbid}_ligand.sdf")
        protein = PDBProtein(protein_path)
        ligand = parse_sdf_file(ligand_path)
        selected = protein.query_residues_ligand({"pos": ligand["pos"]}, radius)
        block = protein.residues_to_pdb_block(selected)
        pocket_fn = os.path.join(pdbid, f"{pdbid}_pocket{int(radius)}.pdb")
        out = os.path.join(dest, pocket_fn)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            f.write(block)
        lig_fn = os.path.join(pdbid, f"{pdbid}_ligand.sdf")
        lig_out = os.path.join(dest, lig_fn)
        if not os.path.exists(lig_out):
            import shutil

            shutil.copyfile(ligand_path, lig_out)
        return {"pocket": pocket_fn, "ligand": lig_fn, "pk": entry["pk"],
                "kind": entry["kind"], "pdbid": pdbid}
    except Exception as e:  # any parse failure: skip this entry, as the reference
        print(f"skip {pdbid}: {type(e).__name__}: {e}")
        return None


def cmd_pockets(args):
    entries = parse_pdbbind_data_index(args.index)
    tasks = [(args.root, args.dest, e, args.radius) for e in entries]
    os.makedirs(args.dest, exist_ok=True)
    if args.num_workers > 1:
        with Pool(args.num_workers) as pool:
            results = pool.map(_extract_one, tasks)
    else:  # one worker: this process, no fork
        results = [_extract_one(t) for t in tasks]
    index = [r for r in results if r is not None]
    with open(os.path.join(args.dest, "index.pkl"), "wb") as f:
        pickle.dump(index, f)
    print(f"extracted {len(index)}/{len(entries)} -> {args.dest}/index.pkl")


def cmd_split(args):
    """Core-set test split (ids listed in a file) or random
    (reference: pdbbind_split.py:9-38)."""
    import random

    import torch

    with open(args.index_pkl, "rb") as f:
        index = pickle.load(f)
    if args.coreset_ids:
        with open(args.coreset_ids) as f:
            core = {l.split()[0] for l in f if l.strip() and not l.startswith("#")}
        test = [i for i, e in enumerate(index) if e["pdbid"] in core]
        train = [i for i, e in enumerate(index) if e["pdbid"] not in core]
    else:
        rng = random.Random(args.seed)
        ids = list(range(len(index)))
        rng.shuffle(ids)
        n_test = int(len(ids) * args.test_frac)
        test, train = ids[:n_test], ids[n_test:]
    torch.save({"train": train, "test": test}, args.dest)
    print(f"train {len(train)} / test {len(test)} -> {args.dest}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pockets")
    p.add_argument("--root", required=True, help="PDBBind general-set root")
    p.add_argument("--index", required=True, help="INDEX_general_PL_data file")
    p.add_argument("--dest", required=True)
    p.add_argument("--radius", type=float, default=10.0)
    p.add_argument("--num_workers", type=int, default=16)
    p.set_defaults(fn=cmd_pockets)

    s = sub.add_parser("split")
    s.add_argument("--index_pkl", required=True)
    s.add_argument("--dest", required=True)
    s.add_argument("--coreset_ids", default=None)
    s.add_argument("--test_frac", type=float, default=0.1)
    s.add_argument("--seed", type=int, default=2020)
    s.set_defaults(fn=cmd_split)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
