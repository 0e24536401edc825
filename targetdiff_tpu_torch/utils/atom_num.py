"""Ligand-size prior conditioned on pocket size. Copy of
targetdiff_tpu/utils/atom_num.py with its own copy of the histogram table.

Reimplements the reference's atom-count sampler
(reference: utils/evaluation/atom_num.py:9-26): pocket "space size" is the
median of the 10 largest pairwise pocket-atom distances; ligand atom counts
are drawn from binned empirical CrossDocked histograms. The histogram table
(reference: utils/evaluation/atom_num_config.py — program-generated data) is
stored as a JSON resource.
"""

from __future__ import annotations

import gzip
import json
from importlib import resources as importlib_resources

import numpy as np

_CONFIG = None


def _config():
    global _CONFIG
    if _CONFIG is None:
        pkg = (importlib_resources.files("targetdiff_tpu_torch") / "resources"
               / "atom_num_prior.json.gz")
        with pkg.open("rb") as f:
            _CONFIG = json.loads(gzip.decompress(f.read()))
    return _CONFIG


def get_space_size(pocket_pos: np.ndarray) -> float:
    """Median of the 10 largest pairwise distances among pocket atoms."""
    pos = np.asarray(pocket_pos, np.float64)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    iu = np.triu_indices(len(pos), k=1)
    dists = np.sqrt(d2[iu])
    dists.sort()
    return float(np.median(dists[-10:]))


def _bin_idx(space_size: float) -> int:
    bounds = _config()["bounds"]
    for i, b in enumerate(bounds):
        if b > space_size:
            return i
    return len(bounds)


def sample_atom_num(space_size: float, rng: np.random.Generator | None = None) -> int:
    rng = rng or np.random.default_rng()
    nums, probs = _config()["bins"][_bin_idx(space_size)]
    return int(rng.choice(nums, p=np.asarray(probs) / np.sum(probs)))
