"""Rule-based chemical perception: hybridization, H-bond donors/acceptors,
hydrophobes, ionizability — approximating the RDKit BaseFeatures families the
reference uses for its 8-column atom feature matrix
(reference: utils/data.py:8-10, :229-231) and the hybridization labels
(reference: utils/data.py:233-240) without RDKit.

Notes on fidelity: the 'Aromatic' column and hybridization labels (which feed
the diffusion model's atom vocabulary, utils/transforms.py:11-66) follow
standard definitions and match RDKit on common drug-like molecules; the
pharmacophore-style families (Acceptor/Donor/Hydrophobe/...) are simplified
SMARTS-free approximations used only by the property-prediction featurizer.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .mol import Molecule

ATOM_FAMILIES = [
    "Acceptor", "Donor", "Aromatic", "Hydrophobe", "LumpedHydrophobe",
    "NegIonizable", "PosIonizable", "ZnBinder",
]
ATOM_FAMILIES_ID = {s: i for i, s in enumerate(ATOM_FAMILIES)}

HYBRIDIZATION_TYPE = ["S", "SP", "SP2", "SP3", "SP3D", "SP3D2"]
HYBRIDIZATION_TYPE_ID = {s: i for i, s in enumerate(HYBRIDIZATION_TYPE)}


def hybridization(mol: Molecule, i: int) -> str:
    """sp/sp2/sp3(+d) from bonding pattern (steric-number heuristic)."""
    a = mol.atoms[i]
    bonds = mol.bonds_of(i)
    n_triple = sum(1 for b in bonds if b.order == 3)
    n_double = sum(1 for b in bonds if b.order == 2)
    n_arom = sum(1 for b in bonds if b.aromatic)
    degree = len(bonds) + mol.implicit_h(i)

    if a.z == 1:
        return "S"
    if a.z in (16, 15) and degree >= 5:
        return "SP3D" if degree == 5 else "SP3D2"
    if a.z == 16 and degree == 4:
        return "SP3"  # sulfone S treated as sp3 by RDKit
    if n_triple or n_double >= 2:
        return "SP"
    if n_double or n_arom or a.aromatic:
        return "SP2"
    # amide/conjugated N: sp2 if bonded to an sp2 carbon with C=O
    if a.z == 7:
        for b in bonds:
            j = b.other(i)
            if mol.atoms[j].z == 6 and any(
                bb.order == 2 and mol.atoms[bb.other(j)].z in (7, 8, 16)
                for bb in mol.bonds_of(j)
            ):
                return "SP2"
    return "SP3"


def hybridization_labels(mol: Molecule) -> List[str]:
    return [hybridization(mol, i) for i in range(mol.num_atoms)]


def is_acceptor(mol: Molecule, i: int) -> bool:
    a = mol.atoms[i]
    if a.z == 8:
        return a.formal_charge <= 0
    if a.z == 7:
        if a.formal_charge > 0:
            return False
        # pyrrole-type N (aromatic with H) donates its lone pair to the ring
        if a.aromatic and mol.implicit_h(i) + a.explicit_h > 0:
            return False
        # amide N is a poor acceptor
        if hybridization(mol, i) == "SP2" and not a.aromatic:
            for b in mol.bonds_of(i):
                j = b.other(i)
                if mol.atoms[j].z == 6 and any(
                    bb.order == 2 and mol.atoms[bb.other(j)].z == 8 for bb in mol.bonds_of(j)
                ):
                    return False
        return True
    return False


def is_donor(mol: Molecule, i: int) -> bool:
    a = mol.atoms[i]
    if a.z not in (7, 8, 16):
        return False
    return (mol.implicit_h(i) + a.explicit_h) > 0


def is_hydrophobe(mol: Molecule, i: int) -> bool:
    a = mol.atoms[i]
    if a.z not in (6, 16, 17, 35, 53):
        return False
    if a.z == 6:
        # carbon not bonded to any heteroatom
        return all(mol.atoms[j].z in (6, 1) for j in mol.neighbors(i))
    return a.z in (17, 35, 53)


def is_neg_ionizable(mol: Molecule, i: int) -> bool:
    a = mol.atoms[i]
    if a.formal_charge < 0:
        return True
    # carboxylic / phosphate / sulfonate acid carbon|P|S and its oxygens
    if a.z in (6, 15, 16):
        ox_d = [j for j in mol.neighbors(i)
                if mol.atoms[j].z == 8 and mol.get_bond(i, j).order == 2]
        ox_s = [j for j in mol.neighbors(i)
                if mol.atoms[j].z == 8 and mol.get_bond(i, j).order == 1
                and mol.degree(j) == 1]
        return bool(ox_d and ox_s)
    return False


def is_pos_ionizable(mol: Molecule, i: int) -> bool:
    a = mol.atoms[i]
    if a.formal_charge > 0:
        return True
    if a.z == 7 and not a.aromatic:
        hyb = hybridization(mol, i)
        if hyb == "SP3":
            # basic amine: no adjacent carbonyl/aromatic withdrawal
            for j in mol.neighbors(i):
                if mol.atoms[j].z == 6:
                    if any(b.order == 2 and mol.atoms[b.other(j)].z in (7, 8)
                           for b in mol.bonds_of(j)):
                        return False
            return True
    # guanidinium / amidine center carbon
    if a.z == 6:
        n_nbrs = [j for j in mol.neighbors(i) if mol.atoms[j].z == 7]
        if len(n_nbrs) >= 2 and any(
            mol.get_bond(i, j).order == 2 for j in n_nbrs
        ):
            return True
    return False


def is_zn_binder(mol: Molecule, i: int) -> bool:
    a = mol.atoms[i]
    if a.z == 16 and (mol.implicit_h(i) + a.explicit_h) > 0:
        return True  # thiol
    if a.z == 7 and a.aromatic:
        return not is_donor(mol, i)  # imidazole-type N
    if a.z == 8 and a.formal_charge < 0:
        return True
    return False


def atom_family_matrix(mol: Molecule) -> np.ndarray:
    """[N, 8] 0/1 matrix in ATOM_FAMILIES order."""
    n = mol.num_atoms
    feat = np.zeros((n, len(ATOM_FAMILIES)), np.int64)
    hydros = []
    for i in range(n):
        a = mol.atoms[i]
        feat[i, ATOM_FAMILIES_ID["Acceptor"]] = is_acceptor(mol, i)
        feat[i, ATOM_FAMILIES_ID["Donor"]] = is_donor(mol, i)
        feat[i, ATOM_FAMILIES_ID["Aromatic"]] = a.aromatic
        h = is_hydrophobe(mol, i)
        feat[i, ATOM_FAMILIES_ID["Hydrophobe"]] = h
        if h:
            hydros.append(i)
        feat[i, ATOM_FAMILIES_ID["NegIonizable"]] = is_neg_ionizable(mol, i)
        feat[i, ATOM_FAMILIES_ID["PosIonizable"]] = is_pos_ionizable(mol, i)
        feat[i, ATOM_FAMILIES_ID["ZnBinder"]] = is_zn_binder(mol, i)
    # LumpedHydrophobe: hydrophobic atoms with >=2 hydrophobic neighbors
    # (approximates RDKit's grouped-hydrophobe patches)
    hs = set(hydros)
    for i in hydros:
        if sum(1 for j in mol.neighbors(i) if j in hs) >= 2:
            feat[i, ATOM_FAMILIES_ID["LumpedHydrophobe"]] = 1
    return feat
