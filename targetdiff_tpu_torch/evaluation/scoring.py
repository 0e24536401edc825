"""Chemical property scoring of generated molecules.

Counterpart of reference utils/evaluation/scoring_func.py: `get_chem`
(QED/SA/logP/Lipinski/ring sizes, :72-88), `is_pains` (:12-23), RMSD and
force-field helpers. Uses RDKit when importable, else the native
chem.descriptors implementations.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..chem import descriptors as D
from ..chem.mol import Molecule

try:  # optional RDKit upgrade path
    from rdkit import Chem as _rdChem  # noqa: F401

    HAVE_RDKIT = True
except ImportError:
    HAVE_RDKIT = False


def get_chem(mol: Molecule) -> Dict:
    """(reference: utils/evaluation/scoring_func.py:72-88)."""
    return {
        "qed": D.qed(mol),
        "sa": D.normalized_sa(mol),
        "logp": D.logp(mol),
        "lipinski": D.obey_lipinski(mol),
        "ring_size": mol.ring_sizes(),
    }


def obey_lipinski(mol: Molecule) -> int:
    return D.obey_lipinski(mol)


def get_logp(mol: Molecule) -> float:
    return D.logp(mol)


def is_pains(mol: Molecule) -> bool:
    """PAINS filtering requires the SMARTS catalog (RDKit FilterCatalog);
    native path returns False (no alert) and flags availability."""
    if not HAVE_RDKIT:
        return False
    from rdkit.Chem.FilterCatalog import FilterCatalog, FilterCatalogParams

    params = FilterCatalogParams()
    params.AddCatalog(FilterCatalogParams.FilterCatalogs.PAINS_A)
    catalog = FilterCatalog(params)
    rdmol = _rdChem.MolFromSmiles(mol.to_smiles())
    return rdmol is not None and catalog.HasMatch(rdmol)


def get_rdkit_rmsd(mol: Molecule, n_conf: int = 20, random_seed: int = 42) -> float:
    """Conformer RMSD between the generated pose and ETKDG+MMFF conformers
    (reference: utils/evaluation/scoring_func.py:45-69). Requires RDKit for
    conformer embedding; returns nan on the native path."""
    if not HAVE_RDKIT:
        return float("nan")
    from rdkit import Chem
    from rdkit.Chem import AllChem

    rdmol = Chem.MolFromMolBlock(_to_molblock(mol))
    if rdmol is None:
        return float("nan")
    mol3d = Chem.AddHs(rdmol)
    rmsd_list = []
    confs = AllChem.EmbedMultipleConfs(mol3d, numConfs=n_conf, randomSeed=random_seed)
    for cid in confs:
        AllChem.MMFFOptimizeMolecule(mol3d, confId=cid)
        rmsd_list.append(AllChem.GetBestRMS(rdmol, Chem.RemoveHs(mol3d), refId=cid))
    return float(np.min(rmsd_list)) if rmsd_list else float("nan")


def _to_molblock(mol: Molecule) -> str:
    from ..chem.sdf import write_sdf

    return write_sdf(mol).replace("$$$$\n", "")


def tanimoto_sim_N_to_1(mols: List[Molecule], ref: Molecule) -> List[float]:
    """(reference: utils/evaluation/similarity.py:16-20)."""
    return [D.tanimoto_sim(m, ref) for m in mols]


def uniqueness(smiles_list: List[str]) -> float:
    return len(set(smiles_list)) / max(len(smiles_list), 1)
