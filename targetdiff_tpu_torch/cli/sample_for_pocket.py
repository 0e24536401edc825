"""Generate molecules for a raw pocket PDB file and write SDF + SMILES.

Usage: python -m targetdiff_tpu_torch.cli.sample_for_pocket configs/sampling.yml
       --pdb_path examples/XXXX_pocket10.pdb [--num_samples 10] [--device cuda]
       [--sampler ddpm|ddim] [--ddim_spacing uniform|quadratic] [--eta ETA]

Counterpart of targetdiff_tpu/cli/sample_for_pocket.py (reference:
scripts/sample_for_pocket.py:18-129): PDB -> featurize -> sample ->
reconstruct -> SDF/SMILES. The checkpoint is the JAX package's .npz, whose
parameters load through utils/port.py.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..chem.pdb import PDBProtein
from ..chem.reconstruct import MolReconsError, reconstruct_from_generated
from ..chem.sdf import write_sdf
from ..config import load_config
from ..data.transforms import (
    FeaturizeProteinAtom,
    get_atomic_number_from_index,
    is_aromatic_from_index,
    num_ligand_classes,
)
from ..models.score_model import DiffusionModel
from ..sampling import sample_diffusion_ligand
from ..utils.port import flax_params_to_state_dict, load_npz_config, load_npz_params


def pdb_to_pocket_data(pdb_path: str, protein_featurizer):
    """PDB -> featurized empty-ligand pocket dict (reference: :18-31)."""
    pocket_dict = PDBProtein(pdb_path).to_dict_atom()
    data = {
        "protein_element": pocket_dict["element"],
        "protein_pos": pocket_dict["pos"],
        "protein_is_backbone": pocket_dict["is_backbone"],
        "protein_atom_to_aa_type": pocket_dict["atom_to_aa_type"],
    }
    return protein_featurizer(data)


def load_model_from_checkpoint(ckpt_path: str, device, max_protein=640, max_ligand=64):
    """Build the DiffusionModel of a targetdiff_tpu .npz checkpoint on `device`."""
    train_config = load_npz_config(ckpt_path)
    protein_feat = FeaturizeProteinAtom()
    mode = train_config.data.transform.ligand_atom_mode
    model = DiffusionModel(train_config.model, protein_feat.feature_dim,
                           num_ligand_classes(mode), device=device,
                           max_protein=max_protein, max_ligand=max_ligand)
    model.net.load_state_dict(flax_params_to_state_dict(load_npz_params(ckpt_path)))
    return model, train_config, protein_feat


def reconstruct_all(pos_list, v_list, mode: str, sdf_path: str, logger):
    """Rebuild molecules; write the connected ones to `sdf_path`. Returns
    their SMILES."""
    smiles_list = []
    for i, (pos, v) in enumerate(zip(pos_list, v_list)):
        try:
            mol = reconstruct_from_generated(
                pos, get_atomic_number_from_index(v, mode), is_aromatic_from_index(v, mode),
                basic_mode=(mode == "basic"))
        except MolReconsError as e:
            logger.info(f"sample {i}: reconstruction failed ({e})")
            continue
        smiles = mol.to_smiles()
        if "." in smiles:
            logger.info(f"sample {i}: fragmented ({smiles})")
            continue
        write_sdf(mol, sdf_path, name=f"sample_{i}", append=True)
        smiles_list.append(smiles)
        logger.info(f"sample {i}: {smiles}")
    return smiles_list


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--pdb_path", required=True)
    ap.add_argument("--num_samples", type=int, default=10)
    ap.add_argument("--num_steps", type=int, default=None)
    ap.add_argument("--sampler", default=None, choices=["ddpm", "ddim"],
                    help="ddim strides the whole schedule over --num_steps jumps")
    ap.add_argument("--ddim_spacing", default=None, choices=["uniform", "quadratic"],
                    help="ddim jump spacing (quadratic: denser at low t)")
    ap.add_argument("--eta", type=float, default=None, help="ddim position noise (default 0)")
    ap.add_argument("--batch_size", type=int, default=100)
    ap.add_argument("--result_path", default="./outputs_pdb")
    ap.add_argument("--max_protein", type=int, default=640)
    ap.add_argument("--max_ligand", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    logger = logging.getLogger("sample_pocket")
    config = load_config(args.config)
    seed = int(config.sample.seed)
    os.makedirs(args.result_path, exist_ok=True)

    model, train_config, protein_feat = load_model_from_checkpoint(
        config.model.checkpoint, args.device, args.max_protein, args.max_ligand)
    data = pdb_to_pocket_data(args.pdb_path, protein_feat)
    result = sample_diffusion_ligand(
        model, {"protein_pos": data["protein_pos"], "protein_feat": data["protein_atom_feature"]},
        num_samples=args.num_samples,
        generator=torch.Generator(device=model.device).manual_seed(seed),
        batch_size=args.batch_size,
        num_steps=args.num_steps or config.sample.num_steps,
        sample_num_atoms=config.sample.get("sample_num_atoms", "prior"),
        max_protein=args.max_protein, max_ligand=args.max_ligand,
        rng=np.random.default_rng(seed),
        sampler=args.sampler or config.sample.get("sampler", "ddpm"),
        eta=args.eta if args.eta is not None else config.sample.get("eta", 0.0),
        ddim_spacing=args.ddim_spacing or config.sample.get("ddim_spacing", "uniform"),
    )
    sdf_path = os.path.join(args.result_path, "samples.sdf")
    if os.path.exists(sdf_path):
        os.remove(sdf_path)
    smiles = reconstruct_all(result["pos"], result["v"],
                             train_config.data.transform.ligand_atom_mode, sdf_path, logger)
    with open(os.path.join(args.result_path, "samples.smi"), "w") as f:
        f.write("\n".join(smiles) + "\n")
    logger.info(f"{len(smiles)}/{len(result['pos'])} molecules -> {sdf_path}")


if __name__ == "__main__":
    main()
