"""Bond orders from empirical bond-length tables: the `get_bond_order` part
of targetdiff_tpu/evaluation/analyze.py (reference:
utils/evaluation/analyze.py:91-103), which reconstruction uses to assign
bond orders. The tables are a copy of the JAX package's resource.
"""

from __future__ import annotations

import gzip
import json
from importlib import resources as importlib_resources

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
