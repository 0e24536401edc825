"""Atom-type distribution JSD vs the frozen CrossDocked element distribution
(reference: utils/evaluation/eval_atom_type.py:15-35, distribution stored as
a JSON resource). Copy of targetdiff_tpu/evaluation/eval_atom_type.py,
reading the port's copy of its resource."""

from __future__ import annotations

import gzip
import json
from collections import Counter
from importlib import resources as importlib_resources

import numpy as np
from scipy import spatial as sci_spatial

_DIST = None


def atom_type_distribution():
    global _DIST
    if _DIST is None:
        pkg = (
            importlib_resources.files("targetdiff_tpu_torch")
            / "resources" / "atom_type_distribution.json.gz"
        )
        with pkg.open("rb") as f:
            raw = json.loads(gzip.decompress(f.read()))
        _DIST = {int(k): float(v) for k, v in raw.items()}
    return _DIST


def eval_atom_type_distribution(pred_counter: Counter) -> float:
    ref = atom_type_distribution()
    total = sum(pred_counter.values())
    pred = np.array([pred_counter.get(k, 0) / max(total, 1) for k in ref])
    return float(sci_spatial.distance.jensenshannon(np.array(list(ref.values())), pred))
