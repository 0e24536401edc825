"""SDF (MDL molfile V2000) reader/writer, dependency-free.

Replaces the reference's RDKit-based SDF parsing (reference:
utils/data.py:213-284 `parse_sdf_file` and datasets/protein_ligand.py:55-111
`parse_sdf_file_text`). Produces the same output dict contract: element, pos,
bond_index, bond_type (1/2/3/4), center_of_mass, hybridization, atom_feature
(the 8 ATOM_FAMILIES columns, approximated by rule-based perception in
chem/perception.py when RDKit is unavailable).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import periodic as PT
from .mol import Molecule


def parse_molfile_text(text: str) -> Molecule:
    lines = text.splitlines()
    if len(lines) < 4:
        raise ValueError("molfile too short")
    counts = lines[3]
    natoms = int(counts[0:3])
    nbonds = int(counts[3:6])
    mol = Molecule()
    for i in range(natoms):
        ln = lines[4 + i]
        x, y, z = float(ln[0:10]), float(ln[10:20]), float(ln[20:30])
        sym = ln[31:34].strip()
        mol.add_atom(PT.atomic_number(sym), pos=(x, y, z))
    for i in range(nbonds):
        ln = lines[4 + natoms + i]
        a1, a2, btype = int(ln[0:3]) - 1, int(ln[3:6]) - 1, int(ln[6:9])
        if btype == 4:
            mol.add_bond(a1, a2, order=1, aromatic=True)
        else:
            mol.add_bond(a1, a2, order=btype)
    # properties block: formal charges
    for ln in lines[4 + natoms + nbonds:]:
        if ln.startswith("M  CHG"):
            fields = ln.split()
            n = int(fields[2])
            for k in range(n):
                idx = int(fields[3 + 2 * k]) - 1
                chg = int(fields[4 + 2 * k])
                mol.atoms[idx].formal_charge = chg
        if ln.startswith("M  END"):
            break
    mol.perceive_aromaticity()
    return mol


def read_sdf(path: str, first_only: bool = True):
    with open(path) as f:
        text = f.read()
    blocks = text.split("$$$$")
    mols = []
    for b in blocks:
        b = b.strip("\n")
        if not b.strip():
            continue
        mols.append(parse_molfile_text(b))
        if first_only:
            return mols[0]
    return mols


def remove_hydrogens(mol: Molecule) -> Molecule:
    """Drop explicit H atoms, carrying their count onto the heavy neighbor
    (matching RDKit RemoveHs semantics used at reference utils/data.py:224)."""
    keep = [i for i, a in enumerate(mol.atoms) if a.z != 1]
    remap = {old: new for new, old in enumerate(keep)}
    out = Molecule()
    for i in keep:
        a = mol.atoms[i]
        j = out.add_atom(a.z, pos=a.pos, formal_charge=a.formal_charge)
        out.atoms[j].aromatic = a.aromatic
        nH = sum(1 for nb in mol.neighbors(i) if mol.atoms[nb].z == 1)
        out.atoms[j].explicit_h = 0  # implicit-H model refills valence
        del nH
    for b in mol.bonds:
        if mol.atoms[b.a1].z == 1 or mol.atoms[b.a2].z == 1:
            continue
        out.add_bond(remap[b.a1], remap[b.a2], order=b.order, aromatic=b.aromatic)
    out.perceive_aromaticity()
    return out


def parse_sdf_file(path: str) -> Dict[str, np.ndarray]:
    """Featurized ligand dict with the reference's key contract
    (reference: utils/data.py:213-284)."""
    mol = read_sdf(path, first_only=True)
    return mol_to_ligand_dict(mol)


def mol_to_ligand_dict(mol: Molecule) -> Dict[str, np.ndarray]:
    """Featurized ligand dict (shared by the SDF and MOL2 parsers)."""
    from .perception import atom_family_matrix, hybridization_labels

    mol = remove_hydrogens(mol)
    n = mol.num_atoms

    pos = np.asarray(mol.positions(), np.float32)
    element = np.array([a.z for a in mol.atoms], np.int64)
    weights = np.array([PT.atomic_weight(z) for z in element])
    com = (pos * weights[:, None]).sum(0) / weights.sum()

    row, col, etype = [], [], []
    for b in mol.bonds:
        t = 4 if b.aromatic else b.order
        row += [b.a1, b.a2]
        col += [b.a2, b.a1]
        etype += [t, t]
    edge_index = np.array([row, col], np.int64).reshape(2, -1)
    edge_type = np.array(etype, np.int64)
    if edge_index.size:
        perm = (edge_index[0] * n + edge_index[1]).argsort()
        edge_index = edge_index[:, perm]
        edge_type = edge_type[perm]

    return {
        "smiles": mol.to_smiles(),
        "element": element,
        "pos": pos,
        "bond_index": edge_index,
        "bond_type": edge_type,
        "center_of_mass": com.astype(np.float32),
        "atom_feature": atom_family_matrix(mol),
        "hybridization": hybridization_labels(mol),
    }


def write_sdf(
    mol: Molecule, path: Optional[str] = None, name: str = "", append: bool = False
) -> str:
    """Serialize to a V2000 molfile block (+ $$$$ terminator)."""
    lines: List[str] = [name, "  targetdiff_tpu", ""]
    nb = len(mol.bonds)
    lines.append(f"{mol.num_atoms:3d}{nb:3d}  0  0  0  0  0  0  0  0999 V2000")
    for a in mol.atoms:
        x, y, z = (a.pos if a.pos is not None else (0.0, 0.0, 0.0))
        lines.append(f"{x:10.4f}{y:10.4f}{z:10.4f} {a.symbol:<3s} 0  0  0  0  0  0  0  0  0  0  0  0")
    for b in mol.bonds:
        t = 4 if b.aromatic else b.order
        lines.append(f"{b.a1 + 1:3d}{b.a2 + 1:3d}{t:3d}  0")
    charged = [(i + 1, a.formal_charge) for i, a in enumerate(mol.atoms) if a.formal_charge]
    for i in range(0, len(charged), 8):
        chunk = charged[i : i + 8]
        lines.append("M  CHG" + f"{len(chunk):3d}" + "".join(f"{ix:4d}{c:4d}" for ix, c in chunk))
    lines.append("M  END")
    lines.append("$$$$")
    block = "\n".join(lines) + "\n"
    if path:
        with open(path, "a" if append else "w") as f:
            f.write(block)
    return block
