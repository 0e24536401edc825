"""Exact Ertl & Schuffenhauer synthetic-accessibility score.

Vendors the fragment-contribution table the reference ships
(reference: utils/evaluation/sascorer.py:1-180 + fpscores.pkl.gz, converted
to resources/sa_fpscores.npz: sorted uint64 Morgan-bit ids + float32 scores)
and implements the published formula:

    SA = scale(score1_fragments + score2_features + score3_symmetry)

* `calculate_sa(rdmol)` is the exact scorer — it needs RDKit only for the
  Morgan fingerprint hashing and stereo/ring perception (identical output to
  the reference's sascorer.calculateScore on the same mol).
* `sa_score_native(mol)` runs the SAME feature/symmetry/scaling pipeline on
  the dependency-free `chem.Molecule`, with the fragment term from a
  commonness surrogate (RDKit's Morgan hashes cannot be reproduced without
  RDKit, so table lookup is impossible natively; the surrogate is calibrated
  to the table's score range [-4, 2.5]).
"""

from __future__ import annotations

import gzip
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .mol import Molecule

_RES = os.path.join(os.path.dirname(__file__), "..", "resources", "sa_fpscores.npz")
_TABLE: Optional[Tuple[np.ndarray, np.ndarray]] = None


def _table() -> Tuple[np.ndarray, np.ndarray]:
    global _TABLE
    if _TABLE is None:
        with np.load(os.path.abspath(_RES)) as z:
            _TABLE = (z["bits"], z["scores"])
    return _TABLE


def fragment_score(fps: Dict[int, int]) -> float:
    """score1: frequency-weighted mean fragment contribution; unknown
    fragments contribute -4 (reference sascorer.py:57-66)."""
    bits, scores = _table()
    ids = np.fromiter(fps.keys(), np.uint64, len(fps))
    counts = np.fromiter(fps.values(), np.float64, len(fps))
    pos = np.searchsorted(bits, ids)
    pos = np.clip(pos, 0, len(bits) - 1)
    hit = bits[pos] == ids
    vals = np.where(hit, scores[pos].astype(np.float64), -4.0)
    nf = counts.sum()
    return float((vals * counts).sum() / max(nf, 1.0))


def _scale(raw: float) -> float:
    """Map raw score into [1, 10] with the smoothed 10-end
    (reference sascorer.py:101-113)."""
    mn, mx = -4.0, 2.5
    sa = 11.0 - (raw - mn + 1.0) / (mx - mn) * 9.0
    if sa > 8.0:
        sa = 8.0 + math.log(sa + 1.0 - 9.0)
    return float(min(max(sa, 1.0), 10.0))


def _feature_scores(n_atoms: int, n_chiral: int, n_spiro: int, n_bridge: int,
                    n_macro: int, n_unique_frags: int) -> Tuple[float, float]:
    size_penalty = n_atoms ** 1.005 - n_atoms
    stereo_penalty = math.log10(n_chiral + 1)
    spiro_penalty = math.log10(n_spiro + 1)
    bridge_penalty = math.log10(n_bridge + 1)
    macro_penalty = math.log10(2) if n_macro > 0 else 0.0
    score2 = -(size_penalty + stereo_penalty + spiro_penalty
               + bridge_penalty + macro_penalty)
    score3 = 0.0
    if n_atoms > n_unique_frags:
        score3 = math.log(float(n_atoms) / n_unique_frags) * 0.5
    return score2, score3


def calculate_sa(rdmol) -> float:
    """Exact reference scorer (requires RDKit for Morgan hashing/perception).
    Numerically identical to utils/evaluation/sascorer.calculateScore."""
    from rdkit import Chem
    from rdkit.Chem import rdMolDescriptors

    fp = rdMolDescriptors.GetMorganFingerprint(rdmol, 2)
    fps = fp.GetNonzeroElements()
    score1 = fragment_score(fps)

    n_atoms = rdmol.GetNumAtoms()
    n_chiral = len(Chem.FindMolChiralCenters(rdmol, includeUnassigned=True))
    ri = rdmol.GetRingInfo()
    n_spiro = rdMolDescriptors.CalcNumSpiroAtoms(rdmol)
    n_bridge = rdMolDescriptors.CalcNumBridgeheadAtoms(rdmol)
    n_macro = sum(1 for x in ri.AtomRings() if len(x) > 8)
    score2, score3 = _feature_scores(
        n_atoms, n_chiral, n_spiro, n_bridge, n_macro, len(fps)
    )
    return _scale(score1 + score2 + score3)


# ---------------------------------------------------------------------------
# native path
# ---------------------------------------------------------------------------


def _native_morgan_counts(mol: Molecule, radius: int = 2) -> Dict[int, int]:
    """Unhashed-to-our-hash circular fragment counts (NOT RDKit-compatible
    ids; used only for the symmetry term and the surrogate)."""
    inv = []
    for i, a in enumerate(mol.atoms):
        inv.append(hash((a.z, mol.degree(i), a.formal_charge,
                         mol.implicit_h(i) + a.explicit_h, int(a.aromatic))))
    counts: Dict[int, int] = {}
    current = list(inv)
    for _ in range(radius + 1):
        for v in current:
            counts[v] = counts.get(v, 0) + 1
        nxt = []
        for i in range(mol.num_atoms):
            nbrs = sorted(
                ((1.5 if (b := mol.get_bond(i, j)).aromatic else b.order), current[j])
                for j in mol.neighbors(i)
            )
            nxt.append(hash((current[i], tuple(nbrs))))
        current = nxt
    return counts


def _native_chiral_centers(mol: Molecule) -> int:
    """Potential stereocenters: sp3 carbons whose heavy-neighbor environments
    are pairwise distinct (includeUnassigned=True analogue)."""
    n = 0
    for i, a in enumerate(mol.atoms):
        if a.z != 6 or a.aromatic:
            continue
        if any(b.order >= 2 for b in mol.bonds_of(i)):
            continue
        nbrs = list(mol.neighbors(i))
        n_h = mol.implicit_h(i) + a.explicit_h
        if len(nbrs) + n_h != 4 or n_h >= 2:
            continue
        sigs = []
        for j in nbrs:
            aj = mol.atoms[j]
            second = tuple(sorted(mol.atoms[k].z for k in mol.neighbors(j) if k != i))
            sigs.append((aj.z, int(aj.aromatic), mol.degree(j), second))
        if len(set(sigs)) == len(sigs):
            n += 1
    return n


def _bridge_spiro_atoms(mol: Molecule) -> Tuple[int, int]:
    """Counts of bridgehead and spiro ATOMS from the SSSR (RDKit semantics:
    spiro = atom shared by two rings sharing only it; bridgehead = atom
    shared by >=2 rings that share more than two atoms... approximated as
    atoms in >=3 ring bonds that are not simple fusion atoms)."""
    rings = [set(r) for r in mol.rings()]
    spiro_atoms = set()
    bridge_atoms = set()
    for i in range(len(rings)):
        for j in range(i + 1, len(rings)):
            shared = rings[i] & rings[j]
            if len(shared) == 1:
                spiro_atoms |= shared
            elif len(shared) > 2:
                # rings sharing a path of >2 atoms: endpoints of the shared
                # path (atoms with a neighbor outside the intersection in
                # both rings) are bridgeheads
                for a in shared:
                    inter_deg = sum(1 for b in mol.neighbors(a) if b in shared)
                    if inter_deg < 2:
                        bridge_atoms.add(a)
                if not any(
                    sum(1 for b in mol.neighbors(a) if b in shared) < 2
                    for a in shared
                ):
                    bridge_atoms |= set(list(shared)[:2])
    return len(bridge_atoms), len(spiro_atoms)


def sa_score_native(mol: Molecule) -> float:
    """Dependency-free SA estimate: exact Ertl feature/symmetry/scaling
    pipeline; fragment term approximated by an element/environment
    commonness surrogate mapped into the table's [-4, 2.5] range."""
    n = mol.num_atoms
    if n == 0:
        return 10.0
    counts = _native_morgan_counts(mol)

    # fragment surrogate in the table's units: common druglike environments
    # (C/N/O, aromatics, halogen decorations) average ~+2 in the vendored
    # table; exotic elements and quaternary centers land strongly negative.
    frag = 0.0
    weight = 0.0
    for i, a in enumerate(mol.atoms):
        heavy_deg = sum(1 for j in mol.neighbors(i) if mol.atoms[j].z != 1)
        if a.z in (6, 7, 8):
            c = 2.2
        elif a.z in (9, 17, 35, 16):  # F/Cl/Br/S: common but sparser table hits
            c = 0.8
        else:
            c = -2.0
        if a.z == 6 and heavy_deg == 4:
            c -= 2.0  # quaternary centers are rare fragments
        if a.aromatic:
            c += 0.3
        frag += c
        weight += 1.0
    score1 = max(-4.0, min(2.5, frag / weight - 0.3))

    rings = mol.rings()
    n_macro = sum(1 for r in rings if len(r) > 8)
    n_bridge, n_spiro = _bridge_spiro_atoms(mol)
    n_chiral = _native_chiral_centers(mol)
    score2, score3 = _feature_scores(n, n_chiral, n_spiro, n_bridge,
                                     n_macro, len(counts))
    return _scale(score1 + score2 + score3)
