"""Synthetic pocket/ligand complexes, a numpy-only port of
targetdiff_tpu/data/synth.py: the same `np.random.Generator` gives the same
complexes, bit for bit, returned as the port's ComplexBatch.

Ligands carry near-ideal covalent geometry (aromatic 5/6-ring scaffolds,
sp2 double bonds, the S/P/Cl vocabulary: 11 of the 13 add_aromatic classes);
pockets fill a 2-10 A shell around the ligand at protein density (the
reference's pocket10 rule, scripts/data_preparation/extract_pockets.py:30-46).
They serve as a training corpus and as benchmark geometry where CrossDocked
is absent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .batch import ComplexBatch, from_numpy
from .transforms import MAP_ATOM_TYPE_AROMATIC_TO_INDEX

# ideal single-bond lengths (Angstrom) between heavy atoms
_BOND = {
    (6, 6): 1.54, (6, 7): 1.47, (6, 8): 1.43, (6, 9): 1.35,
    (7, 7): 1.45, (7, 8): 1.40, (8, 8): 1.48, (7, 9): 1.40, (8, 9): 1.42,
    (6, 15): 1.84, (6, 16): 1.82, (6, 17): 1.77,
    (8, 15): 1.63, (8, 16): 1.57,
}
# double-bond lengths for the sp2 tree chemistry
_DBOND = {(6, 6): 1.33, (6, 7): 1.28, (6, 8): 1.22}
# aromatic (delocalized) in-ring bond lengths
_ARBOND = {(6, 6): 1.39, (6, 7): 1.34, (6, 8): 1.36, (6, 16): 1.71, (7, 7): 1.35}
# max total bond ORDER per element in the tree chemistry (implicit
# hydrogens absorb the rest); S/P kept at their lowest valence states
_MAXVAL = {6: 4, 7: 3, 8: 2, 9: 1, 15: 3, 16: 2, 17: 1}
# acyclic-growth element distribution (C-rich, hetero-seasoned)
_ELEMS = np.array([6, 7, 8, 9, 15, 16, 17])
_ELEM_P = np.array([0.575, 0.10, 0.13, 0.03, 0.035, 0.07, 0.06])

# aromatic ring templates: element sequence around the ring. Substituents
# only attach at ring CARBONS (ring N/O/S have no free valence).
_RING_TEMPLATES = [
    [6, 6, 6, 6, 6, 6],   # benzene
    [7, 6, 6, 6, 6, 6],   # pyridine
    [7, 6, 7, 6, 6, 6],   # pyrimidine
    [8, 6, 6, 6, 6],      # furan
    [16, 6, 6, 6, 6],     # thiophene
    [7, 6, 6, 6, 6],      # pyrrole
]


def _key(z1: int, z2: int):
    return (min(z1, z2), max(z1, z2))


def _bond_len(z1: int, z2: int) -> float:
    return _BOND.get(_key(z1, z2), 1.5)


# realistic bond-length variance: crystallographic/thermal spread of
# heavy-atom single bonds is ~0.01-0.03 A. Ideal (zero-variance) bonds
# make any histogram JSD vs the corpus degenerate at the reference's
# 5 mA DISTANCE_BINS (a delta profile overlaps nothing), so sampled
# geometry could never score well no matter how good the model is.
BOND_SIGMA = 0.02


def _ring_coords(lengths: np.ndarray) -> np.ndarray:
    """Planar closed polygon with prescribed side lengths: vertices on a
    circle of radius R where each side subtends 2*asin(L/(2R)); R solved
    by bisection so the subtended angles sum to 2 pi. Exact closure for
    any (feasible) length set — handles thiophene's unequal C-S/C-C
    sides without ad-hoc coordinates."""
    lengths = np.asarray(lengths, np.float64)
    lo = lengths.max() / 2.0 + 1e-9  # R must exceed every half-chord
    hi = lengths.sum()  # huge R -> angles ~ L/R -> sum < 2 pi

    def angle_sum(R):
        return float(2.0 * np.arcsin(np.clip(lengths / (2.0 * R), 0, 1)).sum())

    # angle_sum decreases with R; find R with angle_sum(R) = 2 pi
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if angle_sum(mid) > 2 * np.pi:
            lo = mid
        else:
            hi = mid
    R = 0.5 * (lo + hi)
    theta = np.concatenate(
        [[0.0], np.cumsum(2.0 * np.arcsin(np.clip(lengths / (2.0 * R), 0, 1)))[:-1]]
    )
    return np.stack([R * np.cos(theta), R * np.sin(theta), np.zeros_like(theta)], 1)


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def synth_ligand(
    rng: np.random.Generator,
    n_min: int = 14,
    n_max: int = 28,
    ring_prob: float = 0.65,
    double_prob: float = 0.18,
):
    """One molecule with near-ideal covalent geometry: optionally an
    aromatic ring scaffold (planar polygon, crystallographic aromatic bond
    lengths), plus an acyclic substituent tree with single/double bonds and
    the S/P/Cl vocabulary. Bond lengths ~ N(ideal, BOND_SIGMA).

    Returns (pos [n,3] f32, atomic_numbers [n] int, v [n] int vocab indices,
    aromatic [n] bool). Tree growth: attach each new atom to a random open
    site, direction chosen among random candidates to maximize clearance
    from non-bonded atoms (keeps inferred bond orders = the intended graph).
    """
    n = int(rng.integers(n_min, n_max + 1))
    pos_l: list = []
    z_l: list = []
    arom_l: list = []
    val_l: list = []  # consumed bond order per atom

    if rng.random() < ring_prob and n >= 11:
        elems = _RING_TEMPLATES[int(rng.integers(len(_RING_TEMPLATES)))]
        m = len(elems)
        lens = np.array(
            [
                _ARBOND[_key(elems[i], elems[(i + 1) % m])]
                + rng.normal(0.0, BOND_SIGMA)
                for i in range(m)
            ]
        )
        ring = _ring_coords(lens) @ _random_rotation(rng).T
        for i in range(m):
            pos_l.append(ring[i])
            z_l.append(elems[i])
            arom_l.append(True)
            # aromatic ring membership consumes 3 order units (1.5 x 2):
            # ring C keeps exactly one open site; ring N/O/S keep none
            val_l.append(3 if elems[i] == 6 else _MAXVAL[elems[i]])
    else:
        pos_l.append(np.zeros(3))
        z_l.append(6)
        arom_l.append(False)
        val_l.append(0)

    while len(pos_l) < n:
        i = len(pos_l)
        # open attachment sites: remaining valence, never F/Cl/ring-hetero
        open_sites = [
            j for j in range(i) if val_l[j] < _MAXVAL[z_l[j]] and _MAXVAL[z_l[j]] > 1
        ]
        if not open_sites:
            open_sites = [int(np.argmin(val_l))]
        j = int(open_sites[rng.integers(len(open_sites))])
        zj = z_l[j]
        # element of the new atom, restricted to sane pairings: carbon sites
        # take anything; N/O sites take C/N/O; S/P sites take only C (and
        # P-O) — no halogen-heteroatom or S-S/S-P chains
        if zj == 6:
            allowed = _ELEMS
        elif zj in (7, 8):
            allowed = np.array([6, 7, 8])
        elif zj == 15:
            allowed = np.array([6, 8])
        else:
            allowed = np.array([6])
        p = _ELEM_P[np.isin(_ELEMS, allowed)]
        zi = int(rng.choice(_ELEMS[np.isin(_ELEMS, allowed)], p=p / p.sum()))
        # double bond when both ends have >= 2 free valence and the pair has
        # sp2 chemistry (C=C / C=O / C=N); never at aromatic ring atoms
        order = 1
        if (
            _key(zi, zj) in _DBOND
            and not arom_l[j]
            and _MAXVAL[zi] - 0 >= 2
            and _MAXVAL[zj] - val_l[j] >= 2
            and rng.random() < double_prob
        ):
            order = 2
        ideal = _DBOND[_key(zi, zj)] if order == 2 else _bond_len(zi, zj)
        blen = ideal + float(rng.normal(0.0, BOND_SIGMA))
        anchor = np.asarray(pos_l[j])
        pos_arr = np.asarray(pos_l)
        # candidate directions: random + (for ring atoms) the outward radial
        cands = rng.normal(size=(24, 3))
        if arom_l[j]:
            ring_c = pos_arr[np.asarray(arom_l)].mean(0)
            out = anchor - ring_c
            cands = np.concatenate([out[None] * 4.0, cands])
        cands /= np.linalg.norm(cands, axis=1, keepdims=True) + 1e-12
        best, best_clear = None, -1.0
        others = np.delete(pos_arr, j, axis=0)
        for d in cands:
            cand = anchor + d * blen
            clear = (
                np.linalg.norm(others - cand, axis=1).min() if len(others) else 10.0
            )
            if clear > best_clear:
                best, best_clear = cand, clear
        pos_l.append(best)
        z_l.append(zi)
        arom_l.append(False)
        val_l.append(order)
        val_l[j] += order

    pos = np.asarray(pos_l, np.float64)
    pos -= pos.mean(0)
    z = np.asarray(z_l, np.int64)
    arom = np.asarray(arom_l, bool)
    v = np.array(
        [
            MAP_ATOM_TYPE_AROMATIC_TO_INDEX[(int(zz), bool(aa))]
            for zz, aa in zip(z, arom)
        ],
        np.int64,
    )
    return pos.astype(np.float32), z, v, arom


def synth_pocket(rng: np.random.Generator, lig_pos: np.ndarray, n_protein: int,
                 feat_dim: int = 27):
    """Protein shell 2-10 A around the ligand at uniform density (pocket10
    rule); features are a plausible random one-hot-ish 27-dim vector (the
    protein featurizer's element/amino-acid/backbone blocks)."""
    keep = np.zeros((0, 3), np.float32)
    while len(keep) < n_protein:
        cand = rng.uniform(-14, 14, size=(n_protein * 40, 3)).astype(np.float32)
        cand += lig_pos.mean(0)
        d = np.sqrt(((cand[:, None] - lig_pos[None]) ** 2).sum(-1)).min(1)
        keep = np.concatenate([keep, cand[(d > 2.0) & (d < 10.0)]])
    ppos = keep[:n_protein]
    feat = np.zeros((n_protein, feat_dim), np.float32)
    elem = rng.choice([0, 1, 2, 3], size=n_protein, p=[0.62, 0.17, 0.16, 0.05])
    feat[np.arange(n_protein), elem] = 1.0  # element block (C/N/O/S-ish)
    aa = rng.integers(0, min(20, feat_dim - 7), size=n_protein)
    feat[np.arange(n_protein), 6 + aa] = 1.0
    feat[:, -1] = (rng.random(n_protein) < 0.4).astype(np.float32)  # backbone
    return ppos, feat


def synth_batch(
    rng: np.random.Generator,
    batch: int,
    max_protein: int = 128,
    max_ligand: int = 32,
    n_protein_range=(96, 128),
    n_ligand_range=(14, 28),
    feat_dim: int = 27,
    ring_prob: float = 0.65,
    device="cpu",
) -> ComplexBatch:
    """A padded ComplexBatch of `batch` independent synthetic complexes on
    `device`."""
    ppos = np.zeros((batch, max_protein, 3), np.float32)
    pfeat = np.zeros((batch, max_protein, feat_dim), np.float32)
    pmask = np.zeros((batch, max_protein), bool)
    lpos = np.zeros((batch, max_ligand, 3), np.float32)
    lv = np.zeros((batch, max_ligand), np.int64)
    lmask = np.zeros((batch, max_ligand), bool)
    for b in range(batch):
        nl_hi = min(n_ligand_range[1], max_ligand)
        lp, _z, v, _a = synth_ligand(rng, n_ligand_range[0], nl_hi,
                                     ring_prob=ring_prob)
        npr = (int(rng.integers(*n_protein_range)) if n_protein_range[0] < n_protein_range[1]
               else n_protein_range[0])
        npr = min(npr, max_protein)
        pp, pf = synth_pocket(rng, lp, npr, feat_dim)
        nl = len(lp)
        lpos[b, :nl] = lp
        lv[b, :nl] = v
        lmask[b, :nl] = True
        ppos[b, :npr] = pp
        pfeat[b, :npr] = pf
        pmask[b, :npr] = True
    return from_numpy(ppos, pfeat, pmask, lpos, lv, lmask, device=device)
