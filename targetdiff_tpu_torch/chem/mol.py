"""Minimal molecule model: atoms, bonds, rings, aromaticity, valence,
implicit hydrogens, and a canonical SMILES writer.

Self-contained replacement for the RDKit/OpenBabel molecule objects the
reference uses throughout (utils/reconstruct.py, utils/evaluation/*). The
SMILES writer uses Morgan-style canonical ranking so identical molecules
produce identical strings (needed for uniqueness/diversity metrics).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import periodic as PT

ORGANIC_SUBSET = {5, 6, 7, 8, 9, 15, 16, 17, 35, 53}


@dataclass
class Atom:
    z: int
    pos: Optional[np.ndarray] = None
    formal_charge: int = 0
    aromatic: bool = False
    explicit_h: int = 0  # explicit hydrogen count carried as attribute
    idx: int = -1

    @property
    def symbol(self) -> str:
        return PT.symbol(self.z)


@dataclass
class Bond:
    a1: int
    a2: int
    order: int = 1  # 1, 2, 3
    aromatic: bool = False

    def other(self, i: int) -> int:
        return self.a2 if i == self.a1 else self.a1


class Molecule:
    def __init__(self):
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self._adj: Dict[int, List[int]] = {}  # atom idx -> bond indices
        self._rings_cache: Optional[List[List[int]]] = None

    # -- construction -------------------------------------------------------

    def add_atom(self, z: int, pos=None, formal_charge: int = 0) -> int:
        idx = len(self.atoms)
        self.atoms.append(
            Atom(z=int(z), pos=None if pos is None else np.asarray(pos, np.float64),
                 formal_charge=formal_charge, idx=idx)
        )
        self._adj[idx] = []
        return idx

    def add_bond(self, a1: int, a2: int, order: int = 1, aromatic: bool = False) -> int:
        assert a1 != a2
        if self.get_bond(a1, a2) is not None:
            raise ValueError(f"duplicate bond {a1}-{a2}")
        bidx = len(self.bonds)
        self.bonds.append(Bond(a1, a2, order, aromatic))
        self._adj[a1].append(bidx)
        self._adj[a2].append(bidx)
        self._rings_cache = None
        return bidx

    def remove_bond(self, a1: int, a2: int) -> None:
        for bidx, b in enumerate(self.bonds):
            if {b.a1, b.a2} == {a1, a2}:
                self.bonds.pop(bidx)
                self._rebuild_adj()
                return
        raise ValueError(f"no bond {a1}-{a2}")

    def _rebuild_adj(self):
        self._adj = {i: [] for i in range(len(self.atoms))}
        for bidx, b in enumerate(self.bonds):
            self._adj[b.a1].append(bidx)
            self._adj[b.a2].append(bidx)
        self._rings_cache = None

    # -- queries ------------------------------------------------------------

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    def neighbors(self, i: int) -> List[int]:
        return [self.bonds[b].other(i) for b in self._adj[i]]

    def bonds_of(self, i: int) -> List[Bond]:
        return [self.bonds[b] for b in self._adj[i]]

    def get_bond(self, a1: int, a2: int) -> Optional[Bond]:
        for b in self._adj.get(a1, []):
            if self.bonds[b].other(a1) == a2:
                return self.bonds[b]
        return None

    def degree(self, i: int) -> int:
        return len(self._adj[i])

    def explicit_valence(self, i: int) -> float:
        """Sum of bond orders (aromatic counts 1.5)."""
        v = 0.0
        for b in self.bonds_of(i):
            v += 1.5 if b.aromatic else b.order
        return v + self.atoms[i].explicit_h

    def implicit_h(self, i: int) -> int:
        """Implicit hydrogens to fill the default valence (organic subset)."""
        a = self.atoms[i]
        if a.z not in ORGANIC_SUBSET:
            return 0
        ev = self.explicit_valence(i)
        # nitrogen in aromatic ring contributing lone pair (pyrrole-like) keeps H
        target_states = PT.VALENCE_STATES.get(a.z, (PT.DEFAULT_VALENCES.get(a.z, 4),))
        adj_charge = a.formal_charge
        if a.z == 7 and adj_charge > 0:
            target_states = (4,)
        elif a.z == 8 and adj_charge > 0:
            target_states = (3,)
        elif adj_charge < 0:
            target_states = tuple(max(t + adj_charge, 0) for t in target_states)
        for t in target_states:
            if ev <= t + 1e-6:
                return int(round(t - ev))
        return 0

    def fragments(self) -> List[List[int]]:
        """Connected components (the '.'-in-SMILES completeness check,
        reference: scripts/evaluate_diffusion.py:100)."""
        seen = set()
        out = []
        for start in range(self.num_atoms):
            if start in seen:
                continue
            comp = []
            stack = [start]
            seen.add(start)
            while stack:
                i = stack.pop()
                comp.append(i)
                for j in self.neighbors(i):
                    if j not in seen:
                        seen.add(j)
                        stack.append(j)
            out.append(sorted(comp))
        return out

    # -- rings --------------------------------------------------------------

    def rings(self, max_size: int = 8) -> List[List[int]]:
        """Smallest ring through each bond (SSSR-like cover), deduplicated."""
        if self._rings_cache is not None:
            return self._rings_cache
        found = {}
        for b in self.bonds:
            ring = self._smallest_ring_through(b.a1, b.a2, max_size)
            if ring:
                key = frozenset(ring)
                if key not in found or len(ring) < len(found[key]):
                    found[key] = ring
        self._rings_cache = list(found.values())
        return self._rings_cache

    def _smallest_ring_through(self, a1: int, a2: int, max_size: int) -> Optional[List[int]]:
        """BFS from a1 to a2 avoiding the direct bond -> smallest cycle."""
        from collections import deque

        prev: Dict[int, Optional[int]] = {a1: None}
        q = deque([a1])
        depth = {a1: 0}
        while q:
            i = q.popleft()
            if depth[i] >= max_size - 1:
                continue
            for j in self.neighbors(i):
                if (i == a1 and j == a2) or (i == a2 and j == a1):
                    continue
                if j not in prev:
                    prev[j] = i
                    depth[j] = depth[i] + 1
                    if j == a2:
                        path = []
                        cur: Optional[int] = a2
                        while cur is not None:
                            path.append(cur)
                            cur = prev[cur]
                        return path if len(path) <= max_size else None
                    q.append(j)
        return None

    def ring_membership(self) -> Dict[int, int]:
        member = {i: 0 for i in range(self.num_atoms)}
        for ring in self.rings():
            for i in ring:
                member[i] += 1
        return member

    def ring_sizes(self) -> List[int]:
        return sorted(len(r) for r in self.rings())

    # -- aromaticity --------------------------------------------------------

    def perceive_aromaticity(self) -> None:
        """Mark 5/6-membered rings aromatic by a Hueckel-style electron count.

        pi-electron contributions: atom with an in-ring double bond -> 1;
        N/O/S with no double bond (lone pair donor) -> 2; carbocation -> 0.
        Ring is aromatic if every atom can conjugate (sp2-capable) and the
        total is 4n+2."""
        for ring in self.rings():
            if len(ring) not in (5, 6):
                continue
            ring_set = set(ring)
            total = 0
            ok = True
            for i in ring:
                a = self.atoms[i]
                if a.z not in (6, 7, 8, 16):
                    ok = False
                    break
                dbl = [
                    b for b in self.bonds_of(i) if b.order == 2 or b.aromatic
                ]
                if dbl:
                    # exocyclic C=O (as in pyridone) contributes 0 from this C
                    in_ring_dbl = [b for b in dbl if b.other(i) in ring_set]
                    total += 1 if in_ring_dbl or any(b.aromatic for b in dbl) else 0
                    if not in_ring_dbl and not any(b.aromatic for b in dbl):
                        # sp2 but contributes empty/0 electrons — still conjugated
                        pass
                elif a.z in (7, 8, 16):
                    total += 2  # lone pair
                elif a.z == 6:
                    if a.formal_charge == 1:
                        total += 0
                    elif a.formal_charge == -1:
                        total += 2
                    else:
                        # sp3 carbon with no double bond: not conjugable
                        if self.degree(i) + self.implicit_h(i) > 3:
                            ok = False
                            break
                        total += 0
            if ok and total % 4 == 2:
                for i in ring:
                    self.atoms[i].aromatic = True
                for i in ring:
                    for b in self.bonds_of(i):
                        if b.other(i) in ring_set:
                            b.aromatic = True

    # -- SMILES -------------------------------------------------------------

    def canonical_ranks(self) -> List[int]:
        """Morgan-style canonical ranking with iterative refinement."""
        n = self.num_atoms
        inv = []
        for i, a in enumerate(self.atoms):
            inv.append(
                (a.z, self.degree(i), a.formal_charge, self.implicit_h(i),
                 int(a.aromatic), round(self.explicit_valence(i) * 2))
            )
        ranks = _ranks_from_keys(inv)
        for _ in range(n):
            new_keys = [
                (ranks[i], tuple(sorted(ranks[j] for j in self.neighbors(i))))
                for i in range(n)
            ]
            new_ranks = _ranks_from_keys(new_keys)
            if new_ranks == ranks:
                break
            ranks = new_ranks
        # tie-break deterministically
        order = sorted(range(n), key=lambda i: (ranks[i], i))
        final = [0] * n
        for r, i in enumerate(order):
            final[i] = r
        return final

    def to_smiles(self, canonical: bool = True, kekulized: Optional[bool] = None) -> str:
        ranks = self.canonical_ranks() if canonical else list(range(self.num_atoms))
        if kekulized is None:
            kekulized = not any(b.aromatic for b in self.bonds)
        writer = _SmilesWriter(self, ranks, kekulized)
        return writer.write()

    # -- convenience --------------------------------------------------------

    def positions(self) -> np.ndarray:
        return np.stack([a.pos for a in self.atoms])

    def heavy_atoms(self) -> List[int]:
        return [i for i, a in enumerate(self.atoms) if a.z != 1]

    def mol_weight(self) -> float:
        w = sum(PT.atomic_weight(a.z) for a in self.atoms)
        w += sum(self.implicit_h(i) * PT.atomic_weight(1) for i in range(self.num_atoms))
        return w


def _ranks_from_keys(keys: Sequence) -> List[int]:
    order = sorted(set(keys))
    lut = {k: r for r, k in enumerate(order)}
    return [lut[k] for k in keys]


_BOND_SMILES = {1: "", 2: "=", 3: "#"}


class _SmilesWriter:
    """Two passes over the SAME deterministic (rank-ordered, recursive) DFS
    tree: pass 1 classifies tree vs ring-closure edges, pass 2 emits."""

    def __init__(self, mol: Molecule, ranks: List[int], kekulized: bool):
        self.mol = mol
        self.ranks = ranks
        self.kekulized = kekulized
        self.children: Dict[int, List[int]] = {}
        self.ring_closures: Dict[Tuple[int, int], int] = {}
        self.next_digit = 1

    def write(self) -> str:
        mol = self.mol
        parts = []
        for frag in mol.fragments():
            start = min(frag, key=lambda i: self.ranks[i])
            self._build_tree(start)
            parts.append(self._emit(start, None))
        return ".".join(parts)

    def _build_tree(self, start: int):
        mol = self.mol
        seen = {start}

        def visit(i: int, parent: Optional[int]):
            self.children[i] = []
            for j in sorted(mol.neighbors(i), key=lambda j: self.ranks[j]):
                if j == parent:
                    continue
                e = (min(i, j), max(i, j))
                if j in seen:
                    if e not in self.ring_closures:
                        self.ring_closures[e] = self.next_digit
                        self.next_digit += 1
                else:
                    seen.add(j)
                    self.children[i].append(j)
                    visit(j, i)

        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, mol.num_atoms * 4 + 100))
        try:
            visit(start, None)
        finally:
            sys.setrecursionlimit(old)

    def _atom_token(self, i: int) -> str:
        a = self.mol.atoms[i]
        sym = a.symbol
        arom = a.aromatic and not self.kekulized
        if arom:
            sym = sym.lower()
        nH = self.mol.implicit_h(i) + a.explicit_h
        simple = (
            a.z in (5, 6, 7, 8, 9, 15, 16, 17, 35, 53)
            and a.formal_charge == 0
            and not (arom and a.z == 7 and nH > 0)  # [nH]
        )
        if simple:
            return sym
        h = f"H{nH}" if nH > 1 else ("H" if nH == 1 else "")
        if a.formal_charge > 0:
            c = "+" if a.formal_charge == 1 else f"+{a.formal_charge}"
        elif a.formal_charge < 0:
            c = "-" if a.formal_charge == -1 else f"-{-a.formal_charge}"
        else:
            c = ""
        return f"[{sym}{h}{c}]"

    def _bond_token(self, b: Bond) -> str:
        if b.aromatic and not self.kekulized:
            return ""
        return _BOND_SMILES.get(b.order, "")

    def _emit(self, i: int, parent: Optional[int]) -> str:
        mol = self.mol
        s = self._atom_token(i)
        # ring closure digits at this atom
        for (a1, a2), digit in self.ring_closures.items():
            if i in (a1, a2):
                b = mol.get_bond(a1, a2)
                d = str(digit) if digit < 10 else f"%{digit}"
                s += self._bond_token(b) + d
        children = self.children.get(i, [])
        for k, j in enumerate(children):
            b = mol.get_bond(i, j)
            sub = self._bond_token(b) + self._emit(j, i)
            if k < len(children) - 1:
                s += f"({sub})"
            else:
                s += sub
        return s
