"""Featurization for the sampling and training paths, counterpart of
targetdiff_tpu/data/transforms.py: the ligand atom-type vocabularies, the
protein atom featurizer, the ligand atom and bond featurizers, the random
rotation augmentation and `Compose`.

The port's copy of the chemistry modules (`chem/`) supplies the aromatic
feature column.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..chem.perception import ATOM_FAMILIES_ID

AROMATIC_FEAT_IDX = ATOM_FAMILIES_ID["Aromatic"]

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


def get_index(atom_num: int, hybridization: Optional[str], is_aromatic: bool, mode: str) -> int:
    """(reference: utils/transforms.py:101-112)."""
    if mode == "basic":
        return MAP_ATOM_TYPE_ONLY_TO_INDEX[int(atom_num)]
    if mode == "add_aromatic":
        key = (int(atom_num), bool(is_aromatic))
        return MAP_ATOM_TYPE_AROMATIC_TO_INDEX.get(key, MAP_ATOM_TYPE_AROMATIC_TO_INDEX[(1, False)])
    return MAP_ATOM_TYPE_FULL_TO_INDEX[(int(atom_num), str(hybridization), bool(is_aromatic))]


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


class FeaturizeLigandAtom:
    """Ligand atom class indices in the chosen vocabulary
    (reference: utils/transforms.py:135-159)."""

    def __init__(self, mode: str = "basic"):
        if mode not in ("basic", "add_aromatic", "full"):
            raise ValueError(f"unknown ligand atom mode {mode!r}")
        self.mode = mode

    @property
    def feature_dim(self) -> int:
        return num_ligand_classes(self.mode)

    def __call__(self, data: Dict) -> Dict:
        elements = np.asarray(data["ligand_element"])
        hybrid = data.get("ligand_hybridization", [None] * len(elements))
        aromatic = np.asarray(data["ligand_atom_feature"])[:, AROMATIC_FEAT_IDX]
        data["ligand_atom_feature_full"] = np.array(
            [get_index(e, h, a, self.mode) for e, h, a in zip(elements, hybrid, aromatic)],
            np.int64)
        return data


NUM_BOND_TYPES = 5  # unspecified, single, double, triple, aromatic


class FeaturizeLigandBond:
    """One-hot over bond types 1..4 (reference: utils/transforms.py:162-169)."""

    def __call__(self, data: Dict) -> Dict:
        bt = np.asarray(data["ligand_bond_type"]) - 1
        data["ligand_bond_feature"] = np.eye(NUM_BOND_TYPES, dtype=np.float32)[bt]
        return data


class RandomRotation:
    """Random QR-orthogonal rotation of the whole complex
    (reference: utils/transforms.py:172-183)."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, data: Dict) -> Dict:
        Q, _ = np.linalg.qr(self.rng.normal(size=(3, 3)))
        Q = Q.astype(np.float32)
        data["ligand_pos"] = np.asarray(data["ligand_pos"]) @ Q
        data["protein_pos"] = np.asarray(data["protein_pos"]) @ Q
        return data


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data
