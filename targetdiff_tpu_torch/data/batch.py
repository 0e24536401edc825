"""Dense padded batch of complexes, counterpart of targetdiff_tpu/data/batch.py.

Each complex is padded to fixed (max_protein, max_ligand) shapes with boolean
validity masks. Fields are torch tensors; `.to(device)` moves them all.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class ComplexBatch(NamedTuple):
    """protein_pos [B,NP,3] f32, protein_feat [B,NP,FP] f32, protein_mask
    [B,NP] bool, ligand_pos [B,NL,3] f32, ligand_v [B,NL] int64, ligand_mask
    [B,NL] bool."""

    protein_pos: torch.Tensor
    protein_feat: torch.Tensor
    protein_mask: torch.Tensor
    ligand_pos: torch.Tensor
    ligand_v: torch.Tensor
    ligand_mask: torch.Tensor

    @property
    def num_graphs(self) -> int:
        return self.protein_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.protein_pos.device

    def to(self, device) -> "ComplexBatch":
        return ComplexBatch(*[t.to(device) for t in self])


def from_numpy(protein_pos, protein_feat, protein_mask, ligand_pos, ligand_v,
               ligand_mask, device="cpu") -> ComplexBatch:
    """Build a batch from numpy arrays (any float/int/bool dtypes)."""
    def t(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)

    return ComplexBatch(
        protein_pos=t(protein_pos, np.float32),
        protein_feat=t(protein_feat, np.float32),
        protein_mask=t(protein_mask, bool),
        ligand_pos=t(ligand_pos, np.float32),
        ligand_v=t(ligand_v, np.int64),
        ligand_mask=t(ligand_mask, bool),
    )


def pad_complex(
    protein_pos: np.ndarray,
    protein_feat: np.ndarray,
    ligand_pos: Optional[np.ndarray],
    ligand_v: Optional[np.ndarray],
    max_protein: int,
    max_ligand: int,
    device="cpu",
) -> ComplexBatch:
    """Pad a single complex to fixed shapes (batch of 1)."""
    np_, nl = len(protein_pos), 0 if ligand_pos is None else len(ligand_pos)
    if np_ > max_protein:
        raise ValueError(f"protein has {np_} atoms > max_protein={max_protein}")
    if nl > max_ligand:
        raise ValueError(f"ligand has {nl} atoms > max_ligand={max_ligand}")
    fp = protein_feat.shape[-1]
    ppos = np.zeros((1, max_protein, 3), np.float32)
    pfeat = np.zeros((1, max_protein, fp), np.float32)
    pmask = np.zeros((1, max_protein), bool)
    ppos[0, :np_] = protein_pos
    pfeat[0, :np_] = protein_feat
    pmask[0, :np_] = True
    lpos = np.zeros((1, max_ligand, 3), np.float32)
    lv = np.zeros((1, max_ligand), np.int64)
    lmask = np.zeros((1, max_ligand), bool)
    if nl:
        lpos[0, :nl] = ligand_pos
        lv[0, :nl] = ligand_v
        lmask[0, :nl] = True
    return from_numpy(ppos, pfeat, pmask, lpos, lv, lmask, device=device)


def replicate(batch: ComplexBatch, n: int) -> ComplexBatch:
    """Tile one pocket n times along the batch axis."""
    return ComplexBatch(*[t.repeat_interleave(n, dim=0) for t in batch])
