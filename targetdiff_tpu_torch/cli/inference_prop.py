"""Predict the binding affinity (Kd/Ki/IC50) of one protein-ligand complex.

Usage: python -m targetdiff_tpu_torch.cli.inference_prop CKPT --protein x.pdb
       --ligand y.sdf [--kind Kd] [--device cuda|cpu]

Counterpart of targetdiff_tpu/cli/inference_prop.py (reference:
scripts/property_prediction/inference.py:31-51, :116-119): extracts the 10 A
pocket around the ligand, featurizes, predicts pK with PropPredNet and
converts it to a molar concentration (10^-pK).
"""

from __future__ import annotations

import argparse
import logging

import torch

from ..chem.pdb import PDBProtein
from ..chem.sdf import parse_sdf_file, read_sdf, remove_hydrogens
from ..data.transforms import FeaturizeProteinAtom
from ..data.transforms_prop import FeaturizeLigandAtomProp, ligand_atom_feature_matrix
from ..models.prop.prop_model import PropPredNet
from ..utils.checkpoint import load_checkpoint
from ..utils.misc_prop import collate_prop
from .common import require_device

KMAP = {"Ki": 1, "Kd": 2, "IC50": 3}


def build_complex(protein_path: str, ligand_path: str, pocket_radius: float = 10.0) -> dict:
    protein = PDBProtein(protein_path)
    ligand = parse_sdf_file(ligand_path)
    selected = protein.query_residues_ligand({"pos": ligand["pos"]}, pocket_radius)
    pocket = PDBProtein(protein.residues_to_pdb_block(selected), mode="block")
    pdict = pocket.to_dict_atom()
    return {
        "protein_element": pdict["element"],
        "protein_pos": pdict["pos"],
        "protein_is_backbone": pdict["is_backbone"],
        "protein_atom_to_aa_type": pdict["atom_to_aa_type"],
        "ligand_element": ligand["element"],
        "ligand_pos": ligand["pos"],
        "ligand_atom_feature": ligand_atom_feature_matrix(remove_hydrogens(read_sdf(ligand_path))),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--protein", required=True)
    ap.add_argument("--ligand", required=True)
    ap.add_argument("--kind", default="Kd", choices=list(KMAP))
    ap.add_argument("--max_protein", type=int, default=768)
    ap.add_argument("--max_ligand", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def run(args) -> float:
    """The predicted pK."""
    device = require_device(args.device)
    ck = load_checkpoint(args.ckpt, device=device)
    protein_feat, ligand_feat = FeaturizeProteinAtom(), FeaturizeLigandAtomProp()
    model = PropPredNet(ck["config"].model, protein_feat.feature_dim, ligand_feat.feature_dim,
                        output_dim=3).to(device)
    model.load_state_dict(ck["state_dict"])
    model.eval()
    data = ligand_feat(protein_feat(build_complex(args.protein, args.ligand)))
    data["kind"] = KMAP[args.kind]
    batch = collate_prop([data], args.max_protein, args.max_ligand, device=device)
    with torch.no_grad():
        pk = float(model(batch)[0])
    molar = 10 ** (-pk)
    if molar < 1e-9:
        conc = f"{molar * 1e12:.2f} pM"
    elif molar < 1e-6:
        conc = f"{molar * 1e9:.2f} nM"
    else:
        conc = f"{molar * 1e6:.2f} uM"
    logging.getLogger("inference_prop").info(f"predicted pK = {pk:.3f}  ({args.kind} = {conc})")
    return pk


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s::%(name)s] %(message)s")
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
