"""Sample molecules for pockets of the test split and write one
result_<id>.pkl per pocket.

Usage: python -m targetdiff_tpu_torch.cli.sample_diffusion configs/sampling.yml
       -i DATA_ID [--all [--sharded]] [--result_path ./outputs] [--device cuda]
       [--sampler ddpm|ddim|dpm2] [--eta ETA] [--ddim_spacing uniform|quadratic]
       [--save_traj STRIDE]
       [--dist_coordinator HOST:PORT --dist_num_processes W --dist_process_id R
        [--dist_backend gloo|nccl]]  (with --all --sharded)

Counterpart of targetdiff_tpu/cli/sample_diffusion.py (reference:
scripts/sample_diffusion.py): loads the checkpoint (the JAX package's .npz
layout), rebuilds the model and transforms from the config stored in it,
samples `sample.num_samples` molecules per pocket and writes the same result
fields. `sample.sampler`, `eta`, `ddim_spacing` (each overridden by its
flag) choose the reverse process; `sample.pos_only` samples positions for
the pocket's own ligand types. With --all --sharded every pocket goes
through `sampling.sample_testset`, `--chunk_rows` rows at a time (no
trajectories, no pos_only): on the one device, or, with the --dist_* flags
(the train CLI's), with each chunk's rows split over W processes, rank 0
writing the result files.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import time

import numpy as np
import torch

from ..config import load_config
from ..data.datasets import get_dataset
from ..data.transforms import Compose, FeaturizeLigandAtom
from ..sampling import sample_diffusion_ligand, sample_testset
from .common import add_dist_args, multi_process, start_mesh
from .sample_for_pocket import load_model_from_checkpoint


def write_result(path, pos_list, v_list, atom_mode, time_list=(), data=None,
                 traj=None) -> None:
    """One result file: the sampled molecules' positions and atom-type
    indices, the sampling seconds, the pocket's `data` and the trajectories
    `traj` = (pos_traj, v_traj, stride), in the fields
    targetdiff_tpu/cli/evaluate_diffusion.py and the port's evaluate_results
    read."""
    out = {"pred_ligand_pos": list(pos_list), "pred_ligand_v": list(v_list),
           "time": list(time_list), "ligand_atom_mode": atom_mode}
    if data is not None:
        out["data"] = data
    if traj is not None:
        out["pred_ligand_pos_traj"], out["pred_ligand_v_traj"], out["traj_stride"] = traj
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _pocket_data(pocket, data):
    return {k: np.asarray(v) for k, v in pocket.items()} | {
        "protein_filename": data.get("protein_filename"),
        "ligand_filename": data.get("ligand_filename")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("-i", "--data_id", type=int, default=0)
    ap.add_argument("--all", action="store_true", help="sample every test pocket")
    ap.add_argument("--result_path", default="./outputs")
    ap.add_argument("--batch_size", type=int, default=100)
    ap.add_argument("--max_protein", type=int, default=640)
    ap.add_argument("--max_ligand", type=int, default=64)
    ap.add_argument("--sharded", action="store_true",
                    help="with --all: sample every pocket through sample_testset, "
                    "--chunk_rows pocket x sample rows at a time")
    ap.add_argument("--chunk_rows", type=int, default=100,
                    help="largest number of pocket x sample rows in flight")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sampler", default=None, choices=["ddpm", "ddim", "dpm2"],
                    help="override config.sample.sampler: ddpm = the reference's ancestral "
                    "sampling; ddim = stride the whole schedule over config.sample.num_steps "
                    "jumps; dpm2 = the Heun (DPM-Solver-2) correction of the ddim jump, two "
                    "model evaluations a jump")
    ap.add_argument("--ddim_spacing", default=None, choices=["uniform", "quadratic"],
                    help="ddim / dpm2 jump spacing (quadratic: denser at low t)")
    ap.add_argument("--save_traj", type=int, default=0, metavar="STRIDE",
                    help="save pred_ligand_{pos,v}_traj every STRIDE steps; not with --sharded")
    ap.add_argument("--eta", type=float, default=None,
                    help="ddim / dpm2 position noise (default 0: deterministic positions)")
    add_dist_args(ap)
    args = ap.parse_args(argv)
    if multi_process(args) and not (args.all and args.sharded):
        raise SystemExit("the --dist_* flags split --all --sharded sampling; add both")
    device, mesh = start_mesh(args)
    try:
        _sample(args, device, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _sample(args, device, mesh):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    logger = logging.getLogger("sample")
    config = load_config(args.config)
    pos_only = bool(config.sample.get("pos_only", False))
    if args.sharded and (args.save_traj or pos_only):
        raise SystemExit("--sharded samples neither trajectories (--save_traj) nor "
                         "positions alone (sample.pos_only); drop one")
    strided = dict(
        sampler=args.sampler or config.sample.get("sampler", "ddpm"),
        eta=args.eta if args.eta is not None else config.sample.get("eta", 0.0),
        ddim_spacing=args.ddim_spacing or config.sample.get("ddim_spacing", "uniform"))
    seed = int(config.sample.seed)
    os.makedirs(args.result_path, exist_ok=True)

    model, train_config, protein_feat = load_model_from_checkpoint(
        config.model.checkpoint, device, args.max_protein, args.max_ligand)
    atom_mode = train_config.data.transform.ligand_atom_mode
    transform = Compose([protein_feat, FeaturizeLigandAtom(atom_mode)])
    _, subsets = get_dataset(train_config.data, transform=transform)
    test_set = subsets["test"]
    ids = range(len(test_set)) if args.all else [args.data_id]
    num_atoms = config.sample.get("sample_num_atoms", "prior")

    if args.sharded:
        datas = [test_set[i] for i in ids]
        pockets = [{"protein_pos": d["protein_pos"], "protein_feat": d["protein_atom_feature"]}
                   for d in datas]
        t0 = time.perf_counter()
        results = sample_testset(
            model, pockets, num_samples_per_pocket=config.sample.num_samples,
            generator=torch.Generator(device=model.device).manual_seed(seed),
            num_steps=config.sample.num_steps, sample_num_atoms=num_atoms,
            max_protein=args.max_protein, max_ligand=args.max_ligand,
            rng=np.random.default_rng(seed), chunk_rows=args.chunk_rows,
            ref_sizes=[len(d["ligand_pos"]) for d in datas], mesh=mesh, **strided)
        elapsed = time.perf_counter() - t0
        if mesh is not None and not mesh.is_main:  # every rank holds the results; 0 writes
            return
        for data_id, data, pocket, result in zip(ids, datas, pockets, results):
            write_result(os.path.join(args.result_path, f"result_{data_id}.pkl"),
                         result["pos"], result["v"], atom_mode, [result["time"]],
                         _pocket_data(pocket, data))
        logger.info(f"sharded: {len(datas)} pockets x {config.sample.num_samples} samples "
                    f"in {elapsed:.1f}s (chunk_rows={args.chunk_rows}, "
                    f"{1 if mesh is None else mesh.world} processes)")
        return

    for data_id in ids:
        data = test_set[data_id]
        pocket = {"protein_pos": data["protein_pos"],
                  "protein_feat": data["protein_atom_feature"]}
        result = sample_diffusion_ligand(
            model, pocket, num_samples=config.sample.num_samples,
            generator=torch.Generator(device=model.device).manual_seed(seed + data_id),
            batch_size=args.batch_size, num_steps=config.sample.num_steps,
            pos_only=pos_only, center_pos_mode=config.sample.get("center_pos_mode", "protein"),
            sample_num_atoms=num_atoms,
            ref_ligand={"ligand_pos": data["ligand_pos"],
                        "ligand_v": data["ligand_atom_feature_full"]},
            max_protein=args.max_protein, max_ligand=args.max_ligand,
            return_traj=bool(args.save_traj), traj_stride=max(args.save_traj, 1),
            rng=np.random.default_rng(seed + data_id), **strided)
        out_path = os.path.join(args.result_path, f"result_{data_id}.pkl")
        traj = ((result["pos_traj"], result["v_traj"], args.save_traj) if args.save_traj
                else None)
        write_result(out_path, result["pos"], result["v"], atom_mode, result["time"],
                     _pocket_data(pocket, data), traj)
        logger.info(f"pocket {data_id}: {len(result['pos'])} molecules in "
                    f"{sum(result['time']):.1f}s -> {out_path}")


if __name__ == "__main__":
    main()
