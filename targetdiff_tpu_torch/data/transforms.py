"""The featurization subset the sampling path needs, counterpart of
targetdiff_tpu/data/transforms.py:64-133.

Kept here rather than imported because importing `targetdiff_tpu.data`
imports jax (its `__init__` pulls in `batch.py`). Only the protein atom
featurizer and the ligand class-index decoders are ported.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# class index maps (reference: utils/transforms.py:11-62)
MAP_ATOM_TYPE_FULL_TO_INDEX = {
    (1, "S", False): 0, (6, "SP", False): 1, (6, "SP2", False): 2,
    (6, "SP2", True): 3, (6, "SP3", False): 4, (7, "SP", False): 5,
    (7, "SP2", False): 6, (7, "SP2", True): 7, (7, "SP3", False): 8,
    (8, "SP2", False): 9, (8, "SP2", True): 10, (8, "SP3", False): 11,
    (9, "SP3", False): 12, (15, "SP2", False): 13, (15, "SP2", True): 14,
    (15, "SP3", False): 15, (15, "SP3D", False): 16, (16, "SP2", False): 17,
    (16, "SP2", True): 18, (16, "SP3", False): 19, (16, "SP3D", False): 20,
    (16, "SP3D2", False): 21, (17, "SP3", False): 22,
}
MAP_ATOM_TYPE_ONLY_TO_INDEX = {1: 0, 6: 1, 7: 2, 8: 3, 9: 4, 15: 5, 16: 6, 17: 7}
MAP_ATOM_TYPE_AROMATIC_TO_INDEX = {
    (1, False): 0, (6, False): 1, (6, True): 2, (7, False): 3, (7, True): 4,
    (8, False): 5, (8, True): 6, (9, False): 7, (15, False): 8, (15, True): 9,
    (16, False): 10, (16, True): 11, (17, False): 12,
}
MAP_INDEX_TO_ATOM_TYPE_ONLY = {v: k for k, v in MAP_ATOM_TYPE_ONLY_TO_INDEX.items()}
MAP_INDEX_TO_ATOM_TYPE_AROMATIC = {v: k for k, v in MAP_ATOM_TYPE_AROMATIC_TO_INDEX.items()}
MAP_INDEX_TO_ATOM_TYPE_FULL = {v: k for k, v in MAP_ATOM_TYPE_FULL_TO_INDEX.items()}


def num_ligand_classes(mode: str) -> int:
    return {"basic": 8, "add_aromatic": 13, "full": 23}[mode]


def get_atomic_number_from_index(index, mode: str) -> List[int]:
    """(reference: utils/transforms.py:69-78)."""
    idx = np.asarray(index).tolist()
    if mode == "basic":
        return [MAP_INDEX_TO_ATOM_TYPE_ONLY[i] for i in idx]
    if mode == "add_aromatic":
        return [MAP_INDEX_TO_ATOM_TYPE_AROMATIC[i][0] for i in idx]
    if mode == "full":
        return [MAP_INDEX_TO_ATOM_TYPE_FULL[i][0] for i in idx]
    raise ValueError(mode)


def is_aromatic_from_index(index, mode: str):
    """(reference: utils/transforms.py:81-90)."""
    idx = np.asarray(index).tolist()
    if mode == "add_aromatic":
        return [MAP_INDEX_TO_ATOM_TYPE_AROMATIC[i][1] for i in idx]
    if mode == "full":
        return [MAP_INDEX_TO_ATOM_TYPE_FULL[i][2] for i in idx]
    if mode == "basic":
        return None
    raise ValueError(mode)


PROTEIN_ATOMIC_NUMBERS = np.array([1, 6, 7, 8, 16, 34])  # H C N O S Se
MAX_NUM_AA = 20


class FeaturizeProteinAtom:
    """One-hot element(6) + one-hot AA(20) + backbone bit => 27-dim
    (reference: utils/transforms.py:115-132)."""

    @property
    def feature_dim(self) -> int:
        return len(PROTEIN_ATOMIC_NUMBERS) + MAX_NUM_AA + 1

    def __call__(self, data: Dict) -> Dict:
        element = np.asarray(data["protein_element"])
        onehot_el = (element[:, None] == PROTEIN_ATOMIC_NUMBERS[None, :]).astype(np.float32)
        onehot_aa = np.eye(MAX_NUM_AA, dtype=np.float32)[np.asarray(data["protein_atom_to_aa_type"])]
        backbone = np.asarray(data["protein_is_backbone"]).astype(np.float32)[:, None]
        data["protein_atom_feature"] = np.concatenate([onehot_el, onehot_aa, backbone], axis=-1)
        return data
