"""Optional RDKit backend: transparently upgrades chem operations when RDKit
is importable (it is a C++ library the reference hard-depends on,
reference: utils/data.py:3-6); otherwise the native implementations in this
package are used."""

from __future__ import annotations

from typing import Optional

from .mol import Molecule
from .sdf import write_sdf

try:
    from rdkit import Chem as _Chem

    HAVE_RDKIT = True
except ImportError:
    _Chem = None
    HAVE_RDKIT = False


def to_rdkit(mol: Molecule):
    """chem.Molecule -> rdkit Mol (None when RDKit is unavailable)."""
    if not HAVE_RDKIT:
        return None
    block = write_sdf(mol).replace("$$$$\n", "")
    return _Chem.MolFromMolBlock(block, sanitize=True)


def from_rdkit(rd) -> Molecule:
    """rdkit Mol -> chem.Molecule (positions from conformer 0 when present)."""
    if not HAVE_RDKIT or rd is None:
        raise ValueError("from_rdkit needs RDKit and a non-None mol")
    mol = Molecule()
    conf = rd.GetConformer(0) if rd.GetNumConformers() else None
    for a in rd.GetAtoms():
        pos = None
        if conf is not None:
            p = conf.GetAtomPosition(a.GetIdx())
            pos = (p.x, p.y, p.z)
        i = mol.add_atom(a.GetAtomicNum(), pos=pos, formal_charge=a.GetFormalCharge())
        mol.atoms[i].aromatic = a.GetIsAromatic()
    for b in rd.GetBonds():
        bt = b.GetBondType()
        aromatic = b.GetIsAromatic() or str(bt) == "AROMATIC"
        order = {"SINGLE": 1, "DOUBLE": 2, "TRIPLE": 3}.get(str(bt), 1)
        mol.add_bond(b.GetBeginAtomIdx(), b.GetEndAtomIdx(), order=order, aromatic=aromatic)
    mol.perceive_aromaticity()
    return mol


def canonical_smiles(mol: Molecule) -> str:
    """RDKit-canonical SMILES when available, else the native writer."""
    if HAVE_RDKIT:
        rd = to_rdkit(mol)
        if rd is not None:
            return _Chem.MolToSmiles(rd)
    return mol.to_smiles()


def qed(mol: Molecule) -> float:
    if HAVE_RDKIT:
        try:
            from rdkit.Chem import QED

            rd = to_rdkit(mol)
            if rd is not None:
                return float(QED.qed(rd))
        except Exception:
            pass
    from .descriptors import qed as native_qed

    return native_qed(mol)


def sa_score(mol: Molecule) -> Optional[float]:
    """Ertl & Schuffenhauer SA. With RDKit: the exact scorer over the
    VENDORED fragment table (identical to the reference's
    utils/evaluation/sascorer.py + fpscores.pkl.gz); without: the native
    estimate (exact feature/scaling pipeline, surrogate fragment term)."""
    if HAVE_RDKIT:
        try:
            from .sascorer import calculate_sa

            rd = to_rdkit(mol)
            if rd is not None:
                return float(calculate_sa(rd))
        except Exception:
            pass
    from .sascorer import sa_score_native

    return sa_score_native(mol)
