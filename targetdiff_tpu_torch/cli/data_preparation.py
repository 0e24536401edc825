"""Dataset preparation: CrossDocked filtering, pocket extraction, splits.
Counterpart of targetdiff_tpu/cli/data_preparation.py, with the same flags
and the same outputs on the same inputs.

Subcommands (counterparts of reference scripts/data_preparation/*):
  clean    — filter CrossDocked2020 by RMSD <= 1.0 from the .types index and
             extract per-pose SDFs (reference: clean_crossdocked.py:22-57)
  pockets  — clip each protein to residues within R Angstrom of its ligand
             (reference: extract_pockets.py:30-46)
  split    — train/test split with unique-pocket test selection
             (reference: split_pl_dataset.py:47-103)

Usage: python -m targetdiff_tpu_torch.cli.data_preparation {clean,pockets,split} ...
"""

from __future__ import annotations

import argparse
import gzip
import os
import pickle
import random
import shutil
from multiprocessing import Pool

import torch


def cmd_clean(args):
    """CrossDocked2020 v1.1 .types line format (reference
    clean_crossdocked.py:22-54): `label affinity rmsd protein_fn ligand_fn ...`
    where ligand_fn = <stem>_<pose>.gninatypes, the raw multi-pose sdf is
    <stem>.sdf.gz, and the receptor pdb is protein_fn with its trailing
    _<suffix> replaced by .pdb. The selected pose is extracted to
    <stem>_<pose>.sdf and the receptor is copied alongside."""
    index = []
    with open(args.types_index) as f:
        for line in f:
            fields = line.split()
            if len(fields) < 5:
                continue
            rmsd = float(fields[2])
            if rmsd > args.rmsd_thr:
                continue
            protein_fn, ligand_fn = fields[3], fields[4]
            pose = int(ligand_fn[ligand_fn.rfind("_") + 1 : ligand_fn.rfind(".")])
            protein_pdb = protein_fn[: protein_fn.rfind("_")] + ".pdb"
            ligand_gz = ligand_fn[: ligand_fn.rfind("_")] + ".sdf.gz"
            protein_path = os.path.join(args.source, protein_pdb)
            ligand_path = os.path.join(args.source, ligand_gz)
            if not (os.path.exists(protein_path) and os.path.exists(ligand_path)):
                continue
            with gzip.open(ligand_path, "rt") as g:
                blocks = g.read().split("$$$$\n")
            if pose >= len(blocks):
                continue
            ligand_out_fn = ligand_fn[: ligand_fn.rfind(".")] + ".sdf"
            protein_dest = os.path.join(args.dest, protein_pdb)
            ligand_dest = os.path.join(args.dest, ligand_out_fn)
            os.makedirs(os.path.dirname(protein_dest), exist_ok=True)
            os.makedirs(os.path.dirname(ligand_dest), exist_ok=True)
            if not os.path.exists(protein_dest):
                shutil.copyfile(protein_path, protein_dest)
            with open(ligand_dest, "w") as o:
                o.write(blocks[pose])
            index.append((protein_pdb, ligand_out_fn, rmsd))
    with open(os.path.join(args.dest, "index.pkl"), "wb") as f:
        pickle.dump(index, f)
    print(f"kept {len(index)} poses -> {args.dest}/index.pkl")


def _extract_one(task):
    from ..chem.pdb import PDBProtein
    from ..chem.sdf import parse_sdf_file

    (source, dest, protein_fn, ligand_fn, radius) = task
    try:
        protein = PDBProtein(os.path.join(source, protein_fn))
        ligand = parse_sdf_file(os.path.join(source, ligand_fn))
        selected = protein.query_residues_ligand({"pos": ligand["pos"]}, radius)
        block = protein.residues_to_pdb_block(selected)
        pocket_fn = ligand_fn.rsplit(".", 1)[0] + f"_pocket{int(radius)}.pdb"
        out = os.path.join(dest, pocket_fn)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            f.write(block)
        # copy the ligand next to the pocket
        lig_out = os.path.join(dest, ligand_fn)
        os.makedirs(os.path.dirname(lig_out), exist_ok=True)
        if not os.path.exists(lig_out):
            shutil.copyfile(os.path.join(source, ligand_fn), lig_out)
        return (pocket_fn, ligand_fn)
    except Exception as e:  # any parse failure: skip this entry, as the reference
        print(f"skip {protein_fn}: {type(e).__name__}: {e}")
        return None


def cmd_pockets(args):
    with open(os.path.join(args.source, "index.pkl"), "rb") as f:
        index = pickle.load(f)
    tasks = [
        (args.source, args.dest, e[0], e[1], args.radius)
        for e in index
        if e[0] is not None
    ]
    os.makedirs(args.dest, exist_ok=True)
    if args.num_workers > 1:
        with Pool(args.num_workers) as pool:
            results = pool.map(_extract_one, tasks)
    else:  # one worker: this process, no fork
        results = [_extract_one(t) for t in tasks]
    new_index = [r for r in results if r is not None]
    with open(os.path.join(args.dest, "index.pkl"), "wb") as f:
        pickle.dump(new_index, f)
    print(f"extracted {len(new_index)} pockets -> {args.dest}")


def cmd_split(args):
    """Random split with a unique-pocket test set
    (reference: split_pl_dataset.py:70-103)."""
    with open(os.path.join(args.path, "index.pkl"), "rb") as f:
        index = pickle.load(f)
    rng = random.Random(args.seed)
    # group by pocket identity (receptor file prefix)
    by_pocket = {}
    for i, entry in enumerate(index):
        if entry[0] is None:
            continue
        pocket_key = os.path.basename(entry[0])[:10]
        by_pocket.setdefault(pocket_key, []).append(i)
    pockets = list(by_pocket)
    rng.shuffle(pockets)
    test_pockets = pockets[: args.num_test_pockets]
    test_ids = [by_pocket[p][0] for p in test_pockets]  # one complex per pocket
    test_set = set(test_pockets)
    train_ids = [
        i for p, ids in by_pocket.items() if p not in test_set for i in ids
    ]
    rng.shuffle(train_ids)
    if args.train_size:
        train_ids = train_ids[: args.train_size]
    split = {"train": train_ids, "test": test_ids}
    torch.save(split, args.dest)
    print(f"train {len(train_ids)} / test {len(test_ids)} -> {args.dest}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("clean")
    c.add_argument("--source", required=True)
    c.add_argument("--dest", required=True)
    c.add_argument("--types_index", required=True)
    c.add_argument("--rmsd_thr", type=float, default=1.0)
    c.set_defaults(fn=cmd_clean)

    p = sub.add_parser("pockets")
    p.add_argument("--source", required=True)
    p.add_argument("--dest", required=True)
    p.add_argument("--radius", type=float, default=10.0)
    p.add_argument("--num_workers", type=int, default=16)
    p.set_defaults(fn=cmd_pockets)

    s = sub.add_parser("split")
    s.add_argument("--path", required=True)
    s.add_argument("--dest", required=True)
    s.add_argument("--num_test_pockets", type=int, default=100)
    s.add_argument("--train_size", type=int, default=0)
    s.add_argument("--seed", type=int, default=2021)
    s.set_defaults(fn=cmd_split)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
