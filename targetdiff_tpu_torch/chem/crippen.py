"""Full Wildman-Crippen logP with exact atom typing (native, no RDKit).

Reproduces the Wildman & Crippen (1999) atom-contribution method the
reference uses through RDKit's ``Descriptors.MolLogP``
(reference: utils/evaluation/scoring_func.py get_logp). The 68 atom classes
are re-expressed as ordered rule predicates over ``chem.Molecule`` —
first-match-wins in the published pattern order, like RDKit's SMARTS table.

Exactness is testable: benzene 1.6866, ethanol -0.0014, acetic acid 0.0909,
pyridine 1.0816 — identical to RDKit's MolLogP (tests/test_crippen.py).
"""

from __future__ import annotations

from typing import List, Optional

from .mol import Bond, Molecule

# ---------------------------------------------------------------------------
# contribution table (Wildman & Crippen 1999, Table 1 — logP column)
# ---------------------------------------------------------------------------
LOGP = {
    "C1": 0.1441, "C2": 0.0, "C3": -0.2035, "C4": -0.2051, "C5": -0.2783,
    "C6": 0.1551, "C7": 0.00170, "C8": 0.08452, "C9": -0.1444, "C10": -0.0516,
    "C11": 0.1193, "C12": -0.0967, "C13": -0.5443, "C14": 0.0, "C15": 0.245,
    "C16": 0.198, "C17": 0.0, "C18": 0.1581, "C19": 0.2955, "C20": 0.2713,
    "C21": 0.1360, "C22": 0.4619, "C23": 0.5437, "C24": 0.1893, "C25": -0.8186,
    "C26": 0.2640, "C27": 0.2148, "CS": 0.08129,
    "H1": 0.1230, "H2": -0.2677, "H3": 0.2142, "H4": 0.2980, "HS": 0.1125,
    "N1": -1.0190, "N2": -0.7096, "N3": -1.0270, "N4": -0.5188, "N5": 0.08387,
    "N6": 0.1836, "N7": -0.3187, "N8": -0.4458, "N9": 0.01508, "N10": -1.950,
    "N11": -0.3239, "N12": -1.119, "N13": -0.3396, "N14": 0.2887, "NS": -0.4806,
    "O1": 0.1552, "O2": -0.2893, "O3": -0.0684, "O4": 0.4833, "O5": 0.0335,
    "O6": -0.3339, "O7": -1.189, "O8": 0.1788, "O9": -0.1526, "O10": 0.1129,
    "O11": 0.4833, "O12": -1.326, "OS": -0.1188,
    "F": 0.4202, "Cl": 0.6895, "Br": 0.8456, "I": 0.8857, "Hal": -2.996,
    "P": 0.8612, "S1": 0.6482, "S2": -0.0024, "S3": 0.6237,
    "Me1": -0.3808, "Me2": -0.0025,
}

_HET = (7, 8, 15, 16, 9, 17, 35, 53)  # N,O,P,S + halogens (C3/C4 targets)
_METALS1 = {3, 4, 11, 12, 19, 20, 13, 31, 32, 37, 38, 49, 50, 51, 55, 56, 81,
            82, 83}


def _arom(mol: Molecule, i: int) -> bool:
    return bool(mol.atoms[i].aromatic)


def _single(b: Bond) -> bool:
    return b.order == 1 and not b.aromatic


def _nbond(mol: Molecule, i: int, order: int) -> int:
    return sum(1 for b in mol.bonds_of(i) if b.order == order and not b.aromatic)


def _nH(mol: Molecule, i: int) -> int:
    return mol.implicit_h(i) + mol.atoms[i].explicit_h


def _X(mol: Molecule, i: int) -> int:
    """Total connections incl. hydrogens (SMARTS X primitive)."""
    return mol.degree(i) + _nH(mol, i)


def _sp3(mol: Molecule, i: int) -> bool:
    return (not _arom(mol, i)
            and all(b.order == 1 and not b.aromatic for b in mol.bonds_of(i))
            and _X(mol, i) == 4)


def _classify_carbon(mol: Molecule, i: int) -> str:
    a = mol.atoms[i]
    nbrs = mol.neighbors(i)
    nh = _nH(mol, i)
    if not a.aromatic:
        single_alC = [j for j in nbrs if mol.atoms[j].z == 6 and not _arom(mol, j)
                      and _single(mol.get_bond(i, j))]
        single_het = [j for j in nbrs if mol.atoms[j].z in _HET and not _arom(mol, j)
                      and _single(mol.get_bond(i, j))]
        dbl = [(j, mol.atoms[j]) for j in nbrs
               if mol.get_bond(i, j).order == 2 and not mol.get_bond(i, j).aromatic]
        trp = [j for j in nbrs if mol.get_bond(i, j).order == 3]
        arom_nbrs = [j for j in nbrs if _arom(mol, j)]
        # C1: CH4 / CH3-C / CH2(C)C  (all-single aliphatic-carbon environment)
        if nh == 4 and not nbrs:
            return "C1"
        if nh == 3 and len(nbrs) == 1 and len(single_alC) == 1:
            return "C1"
        if nh == 2 and len(nbrs) == 2 and len(single_alC) == 2:
            return "C1"
        # C2: CH(C)(C)C / C(C)(C)(C)C
        if nh == 1 and len(nbrs) == 3 and len(single_alC) == 3:
            return "C2"
        if nh == 0 and len(nbrs) == 4 and len(single_alC) == 4:
            return "C2"
        # C3: CH3-het / sp3 CH2-het;  C4: sp3 CH/CH0-het
        if single_het:
            if nh == 3 and len(nbrs) == 1:
                return "C3"
            if _sp3(mol, i):
                if nh == 2:
                    return "C3"
                if nh in (0, 1):
                    return "C4"
        # C5: C=[aliphatic non-C heavy]
        if any(not at.aromatic and at.z != 6 and at.z != 1 for _, at in dbl):
            return "C5"
        # C6: sp2 double-bonded to aliphatic C, aliphatic substituents
        dbl_alC = [j for j, at in dbl if at.z == 6 and not at.aromatic]
        other = [j for j in nbrs if j not in [d[0] for d in dbl]]
        if dbl_alC:
            if nh == 2 and len(nbrs) == 1:
                return "C6"
            if nh == 1 and len(other) == 1 and not _arom(mol, other[0]):
                return "C6"
            if nh == 0 and len(other) == 2 and all(not _arom(mol, j) for j in other):
                return "C6"
            if len(dbl_alC) >= 2:  # allene C(=C)=C
                return "C6"
        # C7: sp carbon [CX2]#A
        if trp and _X(mol, i) == 2:
            return "C7"
        # C8-C12: sp3 (or methyl) carbon attached to aromatics
        if arom_nbrs:
            arom_c = any(mol.atoms[j].z == 6 for j in arom_nbrs)
            if nh == 3 and len(nbrs) == 1:
                return "C8" if arom_c else "C9"
            if _sp3(mol, i):
                if nh == 2:
                    return "C10"
                if nh == 1:
                    return "C11"
                if nh == 0:
                    return "C12"
        # C26: C(=C)(a)A / C(=C)(c)a / CH1(=C)a / C=c
        if dbl_alC and arom_nbrs:
            return "C26"
        if any(at.z == 6 and at.aromatic for _, at in dbl):
            return "C26"
        # C27: sp3 C attached to exotic aliphatic atom
        if _X(mol, i) == 4 and not _arom(mol, i):
            for j in nbrs:
                at = mol.atoms[j]
                if (not at.aromatic and at.z not in (1, 6) + _HET):
                    return "C27"
        return "CS"
    # aromatic carbon
    ring_bonds = [b for b in mol.bonds_of(i) if b.aromatic]
    nonring = [j for j in nbrs if not mol.get_bond(i, j).aromatic]
    # C13: cH0 single-bonded to exotic aliphatic atom
    if nh == 0:
        for j in nonring:
            at = mol.atoms[j]
            if (_single(mol.get_bond(i, j)) and not at.aromatic
                    and at.z not in (1, 6) + _HET[:4] + (9, 17, 35, 53)):
                return "C13"
    # C14-C17: c-halogen
    for j in nonring:
        z = mol.atoms[j].z
        if z == 9:
            return "C14"
        if z == 17:
            return "C15"
        if z == 35:
            return "C16"
        if z == 53:
            return "C17"
    if nh >= 1:
        return "C18"
    # C19: aromatic bridgehead (three aromatic bonds)
    if len(ring_bonds) >= 3:
        return "C19"
    for j in nonring:
        b = mol.get_bond(i, j)
        at = mol.atoms[j]
        if _single(b):
            if at.aromatic:
                return "C20"
            if at.z == 6:
                return "C21"
            if at.z == 7:
                return "C22"
            if at.z == 8:
                return "C23"
            if at.z == 16:
                return "C24"
        if b.order == 2 and at.z in (6, 7, 8):
            return "C25"
    return "CS"


def _classify_nitrogen(mol: Molecule, i: int) -> str:
    a = mol.atoms[i]
    chg = a.formal_charge
    nh = _nH(mol, i)
    nbrs = mol.neighbors(i)
    if a.aromatic:
        return "N11" if chg == 0 else ("N12" if chg > 0 else "N14")
    arom_nbrs = [j for j in nbrs if _arom(mol, j)]
    al_nbrs = [j for j in nbrs if not _arom(mol, j)]
    dbl = [j for j in nbrs
           if mol.get_bond(i, j).order == 2 and not mol.get_bond(i, j).aromatic]
    trp = [j for j in nbrs if mol.get_bond(i, j).order == 3]
    if chg > 0:
        if nh >= 1:
            return "N10"
        if trp:
            return "N14"
        return "N13"
    if chg < 0:
        return "N14"
    # neutral aliphatic N, pattern order N1..N9
    if nh == 2 and len(nbrs) == 1 and not arom_nbrs:
        return "N1"
    if nh == 1 and len(nbrs) == 2 and not arom_nbrs and not dbl:
        return "N2"
    if nh == 2 and len(nbrs) == 1 and arom_nbrs:
        return "N3"
    if nh == 1 and len(nbrs) == 2 and arom_nbrs:
        return "N4"
    if nh == 1 and dbl:
        return "N5"
    if nh == 0 and dbl and len(nbrs) == 2:
        return "N6"
    if nh == 0 and len(nbrs) == 3 and not arom_nbrs and not dbl:
        return "N7"
    if nh == 0 and len(nbrs) == 3 and arom_nbrs:
        return "N8"
    if trp:
        return "N9"
    return "NS"


def _classify_oxygen(mol: Molecule, i: int) -> str:
    a = mol.atoms[i]
    chg = a.formal_charge
    nh = _nH(mol, i)
    nbrs = mol.neighbors(i)
    if a.aromatic:
        return "O1"
    dbl = [j for j in nbrs
           if mol.get_bond(i, j).order == 2 and not mol.get_bond(i, j).aromatic]
    if nh >= 1 and chg == 0:
        return "O2"
    if chg == 0 and len(nbrs) == 2 and not dbl:
        arom_n = [j for j in nbrs if _arom(mol, j)]
        if not arom_n:
            return "O3"
        return "O4"
    # O5: O=N/O=O  or  O(-)–N
    if dbl and mol.atoms[dbl[0]].z in (7, 8):
        return "O5"
    if chg < 0 and len(nbrs) == 1 and mol.atoms[nbrs[0]].z == 7:
        return "O5"
    if chg < 0 and len(nbrs) == 1 and mol.atoms[nbrs[0]].z == 16:
        return "O6"
    if chg == 0 and dbl and mol.atoms[dbl[0]].z == 16:
        return "O6"
    # O12: carboxylate O(-)
    if chg < 0 and len(nbrs) == 1:
        c = nbrs[0]
        if mol.atoms[c].z == 6 and any(
            mol.get_bond(c, k).order == 2 and mol.atoms[k].z == 8
            for k in mol.neighbors(c) if k != i
        ):
            return "O12"
        if mol.atoms[c].z not in (7, 16):
            return "O7"
    if dbl:
        c = dbl[0]
        at = mol.atoms[c]
        if at.z == 6 and at.aromatic:
            return "O8"
        if at.z == 6:
            onbrs = [k for k in mol.neighbors(c) if k != i]
            ozs = sorted(mol.atoms[k].z for k in onbrs)
            oar = [mol.atoms[k].aromatic for k in onbrs]
            c_nh = _nH(mol, c)
            # O9: O=CH-C / O=C(C)(A) / O=CH-[N,O] / O=CH2 / O=C=O
            if c_nh == 1 and len(onbrs) == 1 and ozs == [6] and not oar[0]:
                return "O9"
            if (c_nh == 0 and len(onbrs) == 2
                    and any(mol.atoms[k].z == 6 and not mol.atoms[k].aromatic
                            for k in onbrs)
                    and all(not mol.atoms[k].aromatic for k in onbrs)):
                return "O9"
            if c_nh == 1 and len(onbrs) == 1 and ozs[0] in (7, 8):
                return "O9"
            if c_nh == 2 and not onbrs:
                return "O9"
            if any(mol.get_bond(c, k).order == 2 and mol.atoms[k].z == 8
                   for k in onbrs):
                return "O9"  # O=C=O
            # O10: O=CH-c / O=C([C,c])a / O=C(c)A
            if c_nh == 1 and len(onbrs) == 1 and oar[0]:
                return "O10"
            if (len(onbrs) == 2 and any(oar)
                    and any(mol.atoms[k].z == 6 for k in onbrs)):
                return "O10"
            # O11: O=C(het)(het)
            if len(onbrs) == 2 and all(mol.atoms[k].z not in (1, 6) for k in onbrs):
                return "O11"
    return "OS"


def _classify_sulfur(mol: Molecule, i: int) -> str:
    a = mol.atoms[i]
    if a.aromatic:
        return "S3"
    if a.formal_charge != 0:
        return "S2"
    return "S1"


def classify_atom(mol: Molecule, i: int) -> str:
    z = mol.atoms[i].z
    if z == 6:
        return _classify_carbon(mol, i)
    if z == 7:
        return _classify_nitrogen(mol, i)
    if z == 8:
        return _classify_oxygen(mol, i)
    if z == 16:
        return _classify_sulfur(mol, i)
    if z in (9, 17, 35, 53):
        if mol.atoms[i].formal_charge != 0:
            return "Hal"
        return {9: "F", 17: "Cl", 35: "Br", 53: "I"}[z]
    if z == 15:
        return "P"
    if z in _METALS1:
        return "Me1"
    if z == 1:
        return "H1"
    return "Me2"


def _classify_h(mol: Molecule, parent: int) -> str:
    """H-type from its heavy parent (pattern order H1..H4, HS)."""
    z = mol.atoms[parent].z
    if z in (6, 1):
        return "H1"
    if z == 8:
        heavy = [j for j in mol.neighbors(parent)]
        if not heavy:
            return "HS"
        q = heavy[0]
        qa = mol.atoms[q]
        if qa.z == 6:
            # H4: H-O-C=[C,N,O,S]  (acids, enols)
            if any(
                mol.get_bond(q, k).order == 2
                and mol.atoms[k].z in (6, 7, 8, 16)
                for k in mol.neighbors(q) if k != parent
            ):
                return "H4"
            # H2: H-O-[CX4 or aromatic c]
            if _sp3(mol, q) or qa.aromatic:
                return "H2"
            return "HS"
        if qa.z == 7:
            return "H3"
        if qa.z in (8, 16):
            return "H4"
        return "H2"  # H-O-[not C,N,O,S]
    if z == 7:
        return "H3"
    return "H2"  # H on S, P, Si, ... ([#1][!C;!N;!O])


def atom_types(mol: Molecule) -> List[str]:
    return [classify_atom(mol, i) for i in range(mol.num_atoms)]


def crippen_logp(mol: Molecule) -> float:
    """Wildman-Crippen logP over heavy-atom classes + per-H contributions."""
    total = 0.0
    for i in range(mol.num_atoms):
        t = classify_atom(mol, i)
        total += LOGP.get(t, 0.0)
        if mol.atoms[i].z != 1:
            nh = _nH(mol, i)
            if nh:
                total += nh * LOGP[_classify_h(mol, i)]
    return float(total)
