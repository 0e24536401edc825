"""Molecular descriptors: MW, H-bond counts, TPSA, rotatable bonds, logP,
QED, Lipinski, synthetic-accessibility estimate, Morgan fingerprints and
Tanimoto similarity.

Native implementations of the RDKit descriptors the reference's scoring layer
uses (reference: utils/evaluation/scoring_func.py:72-88 `get_chem`,
utils/evaluation/sascorer.py, utils/evaluation/similarity.py:5-13). Formulas:
  * QED: Bickerton et al. 2012 ADS parameterization (published constants).
  * TPSA: Ertl 2000 fragment contributions (subset covering N/O/S/P).
  * logP: simplified Wildman-Crippen atom typing.
  * SA: Ertl & Schuffenhauer 2009 complexity penalties with a
    fingerprint-frequency surrogate (exact fragment table needs RDKit's
    fpscores; this native path reproduces the size/ring/stereo penalties).
When RDKit is importable these are bypassed in favor of the real thing
(chem.backend).
"""

from __future__ import annotations

import math
from typing import Set

import numpy as np

from .mol import Molecule
from .perception import is_acceptor, is_donor

# ---------------------------------------------------------------------------
# basic counts
# ---------------------------------------------------------------------------


def mol_weight(mol: Molecule) -> float:
    return mol.mol_weight()


def num_hbd(mol: Molecule) -> int:
    return sum(1 for i in range(mol.num_atoms) if is_donor(mol, i))


def num_hba(mol: Molecule) -> int:
    n = 0
    for i, a in enumerate(mol.atoms):
        if a.z in (7, 8):
            # Lipinski HBA counts all N and O
            n += 1
    return n


def num_rotatable_bonds(mol: Molecule) -> int:
    ring_bonds = set()
    for ring in mol.rings():
        rs = set(ring)
        for b in mol.bonds:
            if b.a1 in rs and b.a2 in rs:
                ring_bonds.add((min(b.a1, b.a2), max(b.a1, b.a2)))
    n = 0
    for b in mol.bonds:
        if b.order != 1 or b.aromatic:
            continue
        if (min(b.a1, b.a2), max(b.a1, b.a2)) in ring_bonds:
            continue
        # terminal bonds don't rotate; amide C-N doesn't count
        d1 = sum(1 for j in mol.neighbors(b.a1) if mol.atoms[j].z != 1)
        d2 = sum(1 for j in mol.neighbors(b.a2) if mol.atoms[j].z != 1)
        if d1 < 2 or d2 < 2:
            continue
        if _is_amide_bond(mol, b.a1, b.a2):
            continue
        n += 1
    return n


def _is_amide_bond(mol: Molecule, i: int, j: int) -> bool:
    for (c, nn) in ((i, j), (j, i)):
        if mol.atoms[c].z == 6 and mol.atoms[nn].z == 7:
            if any(b.order == 2 and mol.atoms[b.other(c)].z == 8 for b in mol.bonds_of(c)):
                return True
    return False


def num_aromatic_rings(mol: Molecule) -> int:
    return sum(1 for r in mol.rings() if all(mol.atoms[i].aromatic for i in r))


def num_rings(mol: Molecule) -> int:
    return len(mol.rings())


# ---------------------------------------------------------------------------
# TPSA (Ertl 2000) — contributions for common N/O/S/P environments
# ---------------------------------------------------------------------------


def tpsa(mol: Molecule) -> float:
    total = 0.0
    for i, a in enumerate(mol.atoms):
        if a.z not in (7, 8, 16, 15):
            continue
        nH = mol.implicit_h(i) + a.explicit_h
        arom = a.aromatic
        deg = mol.degree(i)
        orders = sorted(
            (1.5 if b.aromatic else b.order) for b in mol.bonds_of(i)
        )
        if a.z == 7:
            if arom:
                if nH > 0:
                    total += 15.79  # pyrrole NH
                elif deg == 3:
                    total += 4.93  # substituted aromatic N
                else:
                    total += 12.89  # pyridine-type N
            else:
                if nH == 0:
                    total += 3.24 if orders == [1, 1, 1] else (12.36 if 3 in orders else 11.68)
                elif nH == 1:
                    total += 12.03 if orders[:2] == [1, 1] else 21.94
                else:
                    total += 26.02
                if a.formal_charge > 0:
                    total += 4.0
        elif a.z == 8:
            if arom:
                total += 13.14
            elif 2 in orders:
                total += 17.07
            elif nH >= 1:
                total += 20.23
            else:
                total += 9.23
            if a.formal_charge < 0:
                total += 2.0
        elif a.z == 16:
            if arom:
                total += 28.24
            elif 2 in orders:
                total += 32.09
            elif nH >= 1:
                total += 38.80
            else:
                total += 25.30
        elif a.z == 15:
            total += 13.59
    return total


# ---------------------------------------------------------------------------
# logP — full Wildman-Crippen (chem/crippen.py)
# ---------------------------------------------------------------------------


def logp(mol: Molecule) -> float:
    """Wildman-Crippen logP with full 68-class atom typing (chem/crippen.py);
    exact parity with RDKit MolLogP on typed molecules (tests/test_crippen.py).
    Reference: utils/evaluation/scoring_func.py get_logp."""
    from .crippen import crippen_logp

    return crippen_logp(mol)


# ---------------------------------------------------------------------------
# QED (Bickerton et al. 2012) — ADS parameters (published)
# ---------------------------------------------------------------------------

# property: (a, b, c, d, e, f, dmax)
_ADS_PARAMS = {
    "MW": (2.817065973, 392.5754953, 290.7489764, 2.419764353, 49.22325677, 65.37051707, 104.9805561),
    "ALOGP": (3.172690585, 137.8624751, 2.534937431, 4.581497897, 0.822739154, 0.576295591, 131.3186604),
    "HBA": (2.948620388, 160.4605972, 3.615294657, 4.435986202, 0.290141953, 1.300669958, 148.7763046),
    "HBD": (1.618662227, 1010.051101, 0.985094388, 0.000000001, 0.713820843, 0.920922555, 258.1632616),
    "PSA": (1.876861559, 125.2232657, 62.90773554, 87.83366614, 12.01999824, 28.51324732, 104.5686167),
    "ROTB": (0.010000000, 272.4121427, 2.558379970, 1.565547684, 1.271567166, 2.758063707, 105.4420403),
    "AROM": (3.217788970, 957.7374108, 2.274627939, 0.000000001, 1.317690384, 0.375760881, 312.3372610),
    "ALERTS": (0.010000000, 1199.094025, -0.09002883, 0.000000001, 0.185904477, 0.875193782, 417.7253140),
}
_QED_WEIGHTS = {  # mean weights
    "MW": 0.66, "ALOGP": 0.46, "HBA": 0.05, "HBD": 0.61, "PSA": 0.06,
    "ROTB": 0.65, "AROM": 0.48, "ALERTS": 0.95,
}


def _ads(x: float, p) -> float:
    a, b, c, d, e, f, dmax = p
    val = a + b / (1 + math.exp(-(x - c + d / 2) / e)) * (
        1 - 1 / (1 + math.exp(-(x - c - d / 2) / f))
    )
    return val / dmax


def num_structural_alerts(mol: Molecule) -> int:
    """Cheap subset of the Brenk alerts catalog (the full catalog is SMARTS;
    this rule-based subset covers the most common hits)."""
    alerts = 0
    for i, a in enumerate(mol.atoms):
        # N-N, O-O, S-S single bonds; nitro; aldehyde; acyl halide; michael acceptors
        for b in mol.bonds_of(i):
            j = b.other(i)
            if j < i:
                continue
            zi, zj = a.z, mol.atoms[j].z
            if (zi, zj) in ((7, 7), (8, 8), (16, 16)) and not b.aromatic:
                alerts += 1
            if zi == 6 and zj in (17, 35, 53):
                if any(bb.order == 2 and mol.atoms[bb.other(i)].z == 8 for bb in mol.bonds_of(i)):
                    alerts += 1  # acyl halide
        if a.z == 7:
            ox = [j for j in mol.neighbors(i) if mol.atoms[j].z == 8]
            if len(ox) >= 2:
                alerts += 1  # nitro
        if a.z == 6 and not a.aromatic:
            dbl_o = any(b.order == 2 and mol.atoms[b.other(i)].z == 8 for b in mol.bonds_of(i))
            if dbl_o and (mol.implicit_h(i) + a.explicit_h) >= 1 and mol.degree(i) <= 2:
                alerts += 1  # aldehyde
    # 3-membered hetero rings
    for r in mol.rings():
        if len(r) == 3 and any(mol.atoms[i].z != 6 for i in r):
            alerts += 1
        if len(r) >= 8:
            alerts += 1  # macrocycle flag (Brenk)
    return alerts


def qed(mol: Molecule) -> float:
    props = {
        "MW": mol_weight(mol),
        "ALOGP": logp(mol),
        "HBA": num_hba(mol),
        "HBD": num_hbd(mol),
        "PSA": tpsa(mol),
        "ROTB": num_rotatable_bonds(mol),
        "AROM": num_aromatic_rings(mol),
        "ALERTS": num_structural_alerts(mol),
    }
    t = 0.0
    wsum = 0.0
    for k, x in props.items():
        d = max(_ads(float(x), _ADS_PARAMS[k]), 1e-10)
        w = _QED_WEIGHTS[k]
        t += w * math.log(d)
        wsum += w
    return math.exp(t / wsum)


# ---------------------------------------------------------------------------
# SA score (Ertl & Schuffenhauer) — native surrogate
# ---------------------------------------------------------------------------


def sa_score(mol: Molecule) -> float:
    """1 (easy) .. 10 (hard). Exact Ertl feature/symmetry/scaling pipeline
    with a surrogate fragment term (chem/sascorer.py); when RDKit is present
    chem.backend.sa_score uses the exact scorer over the vendored table."""
    from .sascorer import sa_score_native

    return sa_score_native(mol)


def _bridge_spiro(mol: Molecule):
    rings = [set(r) for r in mol.rings()]
    n_bridge = 0
    n_spiro = 0
    for i in range(len(rings)):
        for j in range(i + 1, len(rings)):
            shared = rings[i] & rings[j]
            if len(shared) == 1:
                n_spiro += 1
            elif len(shared) > 2:
                n_bridge += 1
    return n_bridge, n_spiro


def normalized_sa(mol: Molecule) -> float:
    """(10 - SA) / 9 rounded to 2 decimals, exactly the reference's
    compute_sa_score convention (utils/evaluation/sascorer.py:176-180).
    Routes through the backend so the RDKit-exact vendored-table scorer is
    used when available."""
    from .backend import sa_score as backend_sa

    sa = backend_sa(mol)
    if sa is None:
        sa = sa_score(mol)
    return round((10 - sa) / 9, 2)


# ---------------------------------------------------------------------------
# Lipinski
# ---------------------------------------------------------------------------


def obey_lipinski(mol: Molecule) -> int:
    """Count of satisfied rules (0-5)
    (reference: utils/evaluation/scoring_func.py:26-42)."""
    rules = [
        mol_weight(mol) < 500,
        num_hbd(mol) <= 5,
        num_hba(mol) <= 10,
        -2 <= logp(mol) <= 5,
        num_rotatable_bonds(mol) <= 10,
    ]
    return int(sum(rules))


# ---------------------------------------------------------------------------
# Morgan fingerprint + Tanimoto
# ---------------------------------------------------------------------------


def morgan_fingerprint(mol: Molecule, radius: int = 2, n_bits: int = 2048) -> Set[int]:
    """ECFP-style hashed circular fingerprint (bit set)."""
    inv = []
    for i, a in enumerate(mol.atoms):
        inv.append(
            hash((a.z, mol.degree(i), a.formal_charge, mol.implicit_h(i), int(a.aromatic)))
        )
    bits = set()
    current = list(inv)
    for _ in range(radius + 1):
        for i, v in enumerate(current):
            bits.add(v % n_bits)
        nxt = []
        for i in range(mol.num_atoms):
            nbrs = sorted(
                (1.5 if (b := mol.get_bond(i, j)).aromatic else b.order, current[j])
                for j in mol.neighbors(i)
            )
            nxt.append(hash((current[i], tuple(nbrs))))
        current = nxt
    return bits


def tanimoto_sim(mol1: Molecule, mol2: Molecule) -> float:
    """(reference: utils/evaluation/similarity.py:5-13)."""
    f1, f2 = morgan_fingerprint(mol1), morgan_fingerprint(mol2)
    if not f1 and not f2:
        return 0.0
    return len(f1 & f2) / len(f1 | f2)
