"""Featurization for property (affinity) prediction.

Counterpart of reference utils/transforms_prop.py: protein features are the
same 27-dim one-hots; ligand atoms get element one-hot (8) + the ATOM_FEATS
property one-hots (AtomicNumber/100, Aromatic, Degree(6), NumHs(6),
Hybridization(8)) => 30-dim (reference: utils/transforms_prop.py:31-69,
datasets/protein_ligand.py:14 ATOM_FEATS, :20-52 get_ligand_atom_features).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..chem.mol import Molecule
from ..chem.perception import HYBRIDIZATION_TYPE
from .transforms import FeaturizeProteinAtom  # same 27-dim protein features

# RDKit HybridizationType enumeration order (UNSPECIFIED..OTHER)
RD_HYBRID_ORDER = ["UNSPECIFIED", "S", "SP", "SP2", "SP3", "SP3D", "SP3D2", "OTHER"]
ATOM_FEATS = {"AtomicNumber": 1, "Aromatic": 1, "Degree": 6, "NumHs": 6,
              "Hybridization": len(RD_HYBRID_ORDER)}
LIGAND_ELEMENTS = np.array([1, 6, 7, 8, 9, 15, 16, 17])


def ligand_atom_feature_matrix(mol: Molecule) -> np.ndarray:
    """[N, 5] integer matrix (atomic_number, aromatic, degree, num_hs,
    hybridization index) (reference: datasets/protein_ligand.py:20-52)."""
    rows = []
    for i, a in enumerate(mol.atoms):
        hyb = _hybrid_index(mol, i)
        num_h = sum(1 for j in mol.neighbors(i) if mol.atoms[j].z == 1)
        rows.append([a.z, int(a.aromatic), mol.degree(i), num_h, hyb])
    return np.asarray(rows, np.int64)


def _hybrid_index(mol: Molecule, i: int) -> int:
    from ..chem.perception import hybridization

    name = hybridization(mol, i)
    return RD_HYBRID_ORDER.index(name) if name in RD_HYBRID_ORDER else 7


class FeaturizeLigandAtomProp:
    """Element one-hot + property one-hots => 30-dim
    (reference: utils/transforms_prop.py:31-69)."""

    @property
    def num_properties(self) -> int:
        return sum(ATOM_FEATS.values())

    @property
    def feature_dim(self) -> int:
        return len(LIGAND_ELEMENTS) + self.num_properties

    def __call__(self, data: Dict) -> Dict:
        element = np.asarray(data["ligand_element"])
        onehot_el = (element[:, None] == LIGAND_ELEMENTS[None, :]).astype(np.float32)
        feat = np.asarray(data["ligand_atom_feature"])
        if feat.shape[-1] == 8:
            # parsed via the diffusion path (ATOM_FAMILIES matrix): derive the
            # prop matrix from the molecule columns we have
            raise ValueError(
                "prop featurization needs the 5-column property matrix "
                "(use ligand_atom_feature_matrix)"
            )
        cols = []
        i = 0
        for k, v in ATOM_FEATS.items():
            col = feat[:, i : i + 1]
            if v > 1:
                col = (col == np.arange(v)[None, :]).astype(np.float32)
            elif k == "AtomicNumber":
                col = col.astype(np.float32) / 100.0
            else:
                col = col.astype(np.float32)
            cols.append(col)
            i += 1
        data["ligand_atom_feature_full"] = np.concatenate([onehot_el] + cols, axis=-1)
        return data


class EdgeConnection:
    """Precompute a kNN edge list between/within protein and ligand atoms on
    the host (reference: utils/transforms_prop.py:114-131). kind='l2l' or
    'pl' (bipartite protein->ligand)."""

    def __init__(self, kind: str = "l2l", k: int = 32):
        assert kind in ("l2l", "pl")
        self.kind = kind
        self.k = k

    def __call__(self, data: Dict) -> Dict:
        lig = np.asarray(data["ligand_pos"])
        if self.kind == "l2l":
            src_pos = dst_pos = lig
        else:
            src_pos = np.asarray(data["protein_pos"])
            dst_pos = lig
        d = np.linalg.norm(dst_pos[:, None, :] - src_pos[None, :, :], axis=-1)
        if self.kind == "l2l":
            np.fill_diagonal(d, np.inf)
        k = min(self.k, d.shape[1] - (1 if self.kind == "l2l" else 0))
        nn = np.argsort(d, axis=1)[:, :k]
        dst = np.repeat(np.arange(len(dst_pos)), k)
        src = nn.reshape(-1)
        data[f"{self.kind}_edge_index"] = np.stack([src, dst])
        return data


class LigandCountNeighbors:
    """Bond-degree features from the bond graph
    (reference: utils/transforms_prop.py:81-111)."""

    @staticmethod
    def count(bond_index, symmetry=True, valence=None, num_nodes=None):
        n = num_nodes
        out = np.zeros(n, np.int64)
        w = np.ones(bond_index.shape[1], np.int64) if valence is None else np.asarray(valence)
        for (j, i, v) in zip(bond_index[0], bond_index[1], w):
            out[int(i)] += int(v)
        return out

    def __call__(self, data: Dict) -> Dict:
        n = len(data["ligand_element"])
        data["ligand_num_neighbors"] = self.count(
            data["ligand_bond_index"], num_nodes=n
        )
        data["ligand_atom_valence"] = self.count(
            data["ligand_bond_index"], valence=data["ligand_bond_type"], num_nodes=n
        )
        return data
