"""Bond-length distribution metrics: per-bond-type and pair-distance JSD
against frozen CrossDocked empirical distributions.

Copy of targetdiff_tpu/evaluation/eval_bond_length.py, reading the port's
copy of its resource. Counterpart of reference
utils/evaluation/eval_bond_length.py (+ the frozen
distributions from eval_bond_length_config.py:3-13, stored here as a JSON
resource). Bond types are (z1, z2, order) with order 4 = aromatic.
"""

from __future__ import annotations

import collections
import gzip
import json
from importlib import resources as importlib_resources
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import spatial as sci_spatial

BondType = Tuple[int, int, int]
BondLengthData = Tuple[BondType, float]

_CFG = None


def _cfg():
    global _CFG
    if _CFG is None:
        pkg = (
            importlib_resources.files("targetdiff_tpu_torch")
            / "resources" / "bond_length_empirical.json.gz"
        )
        with pkg.open("rb") as f:
            raw = json.loads(gzip.decompress(f.read()))
        _CFG = {
            "distance_bins": np.asarray(raw["DISTANCE_BINS"]),
            "empirical": {
                tuple(json.loads(k.replace("(", "[").replace(")", "]"))): np.asarray(v)
                for k, v in raw["EMPIRICAL_DISTRIBUTIONS"].items()
            },
            "pair_bins": {k: np.asarray(v) for k, v in raw["PAIR_EMPIRICAL_BINS"].items()},
            "pair_empirical": {
                k: np.asarray(v) for k, v in raw["PAIR_EMPIRICAL_DISTRIBUTIONS"].items()
            },
        }
    return _CFG


def get_distribution(distances: Sequence[float], bins=None) -> np.ndarray:
    """Histogram over `bins` edges, +1 overflow bucket, normalized."""
    if bins is None:
        bins = _cfg()["distance_bins"]
    counts = collections.Counter(np.searchsorted(bins, distances))
    out = np.array([counts.get(i, 0) for i in range(len(bins) + 1)], np.float64)
    return out / max(out.sum(), 1)


def _format_bond_type(bt: BondType) -> BondType:
    a1, a2, cat = bt
    return (a2, a1, cat) if a1 > a2 else (a1, a2, cat)


def get_bond_length_profile(bond_lengths: Sequence[BondLengthData]) -> Dict[BondType, np.ndarray]:
    grouped = collections.defaultdict(list)
    for bt, d in bond_lengths:
        grouped[_format_bond_type(bt)].append(d)
    return {k: get_distribution(v) for k, v in grouped.items()}


def _bond_type_str(bt: BondType) -> str:
    return f"{bt[0]}-{bt[1]}|{bt[2]}"


def eval_bond_length_profile(profile: Dict[BondType, np.ndarray]) -> Dict[str, Optional[float]]:
    metrics = {}
    for bt, gt in _cfg()["empirical"].items():
        key = f"JSD_{_bond_type_str(bt)}"
        if bt not in profile:
            metrics[key] = None
        else:
            metrics[key] = float(sci_spatial.distance.jensenshannon(gt, profile[bt]))
    return metrics


def get_pair_length_profile(pair_lengths) -> Dict[str, np.ndarray]:
    cc = [d for (pair, d) in pair_lengths if pair == (6, 6) and d < 2]
    al = [d for (_, d) in pair_lengths if d < 12]
    return {
        "CC_2A": get_distribution(cc, bins=np.linspace(0, 2, 100)),
        "All_12A": get_distribution(al, bins=np.linspace(0, 12, 100)),
    }


def eval_pair_length_profile(profile) -> Dict[str, Optional[float]]:
    metrics = {}
    for k, gt in _cfg()["pair_empirical"].items():
        metrics[f"JSD_{k}"] = (
            float(sci_spatial.distance.jensenshannon(gt, profile[k])) if k in profile else None
        )
    return metrics


def pair_distance_from_pos_v(pos: np.ndarray, elements: Sequence[int]) -> List:
    """All unordered atom-pair distances annotated with element pairs."""
    pos = np.asarray(pos)
    diff = pos[None, :] - pos[:, None]
    pdist = np.sqrt((diff**2).sum(-1))
    out = []
    n = len(pos)
    for s in range(n):
        for e in range(s + 1, n):
            out.append(((int(elements[s]), int(elements[e])), float(pdist[s, e])))
    return out


def bond_distance_from_mol(mol) -> List[BondLengthData]:
    """Bond lengths of a chem.Molecule (order 4 = aromatic)."""
    pos = mol.positions()
    out = []
    for b in mol.bonds:
        t = 4 if b.aromatic else b.order
        d = float(np.linalg.norm(pos[b.a1] - pos[b.a2]))
        out.append(((mol.atoms[b.a1].z, mol.atoms[b.a2].z, t), d))
    return out


def plot_distance_hist(pair_length_profile, metrics=None, save_path=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cfg = _cfg()
    gt_profile = cfg["pair_empirical"]
    plt.figure(figsize=(6 * len(gt_profile), 4))
    for idx, (k, gt) in enumerate(gt_profile.items()):
        plt.subplot(1, len(gt_profile), idx + 1)
        x = cfg["pair_bins"][k]
        plt.step(x, gt[1:])
        plt.step(x, pair_length_profile[k][1:])
        plt.legend(["True", "Learned"])
        title = k if metrics is None else f"{k} JS div: {metrics['JSD_' + k]:.4f}"
        plt.title(title)
    if save_path:
        plt.savefig(save_path)
    plt.close()
