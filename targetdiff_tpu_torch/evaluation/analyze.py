"""Molecular stability from empirical bond-order tables, and the
distribution distances of the evaluation. Copy of
targetdiff_tpu/evaluation/analyze.py without its C++ (tdnative) fast path
(reference: utils/evaluation/analyze.py): pairwise distances are compared to
empirical single/double/triple bond-length tables (margins 10/5/3 pm) to
infer bond orders; an atom is stable when its inferred valence is allowed
for its element. The tables are a copy of the JAX package's resource.
"""

from __future__ import annotations

import gzip
import json
from importlib import resources as importlib_resources
from typing import Sequence

import numpy as np

from ..chem import periodic as PT

_TABLES = None


def _tables():
    global _TABLES
    if _TABLES is None:
        pkg = (importlib_resources.files("targetdiff_tpu_torch") / "resources"
               / "bond_order_tables.json.gz")
        with pkg.open("rb") as f:
            _TABLES = json.loads(gzip.decompress(f.read()))
    return _TABLES


def get_bond_order(atom1: str, atom2: str, distance: float) -> int:
    """Bond order (0-3) from distance in Angstrom. Margins in pm: single +10,
    double +5, triple +3."""
    t = _tables()
    d = 100 * distance  # pm
    b1, b2, b3 = t["bonds1"], t["bonds2"], t["bonds3"]
    m1, m2, m3 = t["margins"]
    if atom1 in b1 and atom2 in b1[atom1]:
        thr1 = b1[atom1][atom2] + m1
        if d < thr1:
            order = 1
            if atom1 in b2 and atom2 in b2.get(atom1, {}):
                thr2 = b2[atom1][atom2] + m2
                if d < thr2:
                    order = 2
                    if atom1 in b3 and atom2 in b3.get(atom1, {}):
                        thr3 = b3[atom1][atom2] + m3
                        if d < thr3:
                            order = 3
            return order
    return 0


def check_stability(
    positions: np.ndarray,
    atom_types: Sequence[int],
    debug: bool = False,
    hs: bool = False,
    return_nr_bonds: bool = False,
):
    """(molecule_stable, n_stable_atoms, n_atoms)
    (reference: utils/evaluation/analyze.py:106-143). `atom_types` are atomic
    numbers. Without explicit hydrogens (hs=False) an atom is stable when
    0 < inferred valence <= allowed valence; with hs it must match exactly."""
    t = _tables()
    allowed = t["allowed_bonds"]
    pos = np.asarray(positions, np.float64)
    n = len(pos)
    if len(atom_types) != n:
        raise ValueError(f"{len(atom_types)} atom types for {n} positions")

    sym = [PT.symbol(int(z)) for z in atom_types]
    valences = _count_valences(pos, atom_types, sym, n)

    n_stable = 0
    for i in range(n):
        a = allowed.get(sym[i])
        if a is None:
            continue
        if hs:
            ok = valences[i] == a
        else:
            ok = 0 < valences[i] <= a
        if debug and not ok:
            print(f"unstable {sym[i]}: valence {valences[i]} allowed {a}")
        n_stable += int(ok)
    if return_nr_bonds:
        return n_stable == n, int(n_stable), n, valences
    return n_stable == n, int(n_stable), n


def _count_valences(pos, atom_types, sym, n):
    valences = np.zeros(n, np.int64)
    for i in range(n):
        for j in range(i + 1, n):
            dist = float(np.linalg.norm(pos[i] - pos[j]))
            order = get_bond_order(sym[i], sym[j], dist)
            valences[i] += order
            valences[j] += order
    return valences


# -- distribution distances (reference: utils/evaluation/analyze.py:60-88) --


def kl_divergence(p_hist, q_hist, eps: float = 1e-10) -> float:
    p = np.asarray(p_hist, np.float64) + eps
    q = np.asarray(q_hist, np.float64) + eps
    p, q = p / p.sum(), q / q.sum()
    return float(np.sum(p * np.log(p / q)))


def js_divergence(p_hist, q_hist, eps: float = 1e-10) -> float:
    p = np.asarray(p_hist, np.float64) + eps
    q = np.asarray(q_hist, np.float64) + eps
    p, q = p / p.sum(), q / q.sum()
    m = 0.5 * (p + q)
    return float(0.5 * np.sum(p * np.log(p / m)) + 0.5 * np.sum(q * np.log(q / m)))


def emd(p_hist, q_hist) -> float:
    p = np.asarray(p_hist, np.float64)
    q = np.asarray(q_hist, np.float64)
    p, q = p / max(p.sum(), 1e-10), q / max(q.sum(), 1e-10)
    return float(np.abs(np.cumsum(p) - np.cumsum(q)).sum())
