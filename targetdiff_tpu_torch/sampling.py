"""Pocket-conditioned sampling pipeline, counterpart of
targetdiff_tpu/sampling.py:33-217 (reference: scripts/sample_diffusion.py:31-116).

One pocket is padded once and replicated across the batch; ligand sizes come
from the atom-count prior on the host and become masks; init positions are
the pocket's centre of mass plus N(0, 1) and init types are uniform. All
noise is drawn from the caller's `torch.Generator`.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .data.batch import ComplexBatch
from .models.score_model import DiffusionModel
from .utils import atom_num


def init_ligand_state(batch: ComplexBatch, num_classes: int, generator: torch.Generator):
    """(init_pos [B,NL,3], init_v [B,NL]) (reference: scripts/sample_diffusion.py:60-70)."""
    m = batch.protein_mask.float()[..., None]
    com = (batch.protein_pos * m).sum(1, keepdim=True) / m.sum(1, keepdim=True).clamp(min=1.0)
    dev = batch.device
    init_pos = com + torch.randn(batch.ligand_pos.shape, generator=generator, device=dev)
    uniform = torch.rand(batch.ligand_v.shape + (num_classes,), generator=generator, device=dev)
    init_v = torch.argmax(-torch.log(-torch.log(uniform + 1e-30) + 1e-30), dim=-1)
    return init_pos, init_v


def sample_ligand_sizes(protein_pos: np.ndarray, n: int, mode: str = "prior",
                        ref_size: Optional[int] = None, max_ligand: int = 64,
                        rng: Optional[np.random.Generator] = None,
                        start_index: int = 0) -> np.ndarray:
    """Per-sample ligand atom counts (reference: scripts/sample_diffusion.py:45-57).
    mode: prior | range | ref."""
    rng = rng or np.random.default_rng()
    if mode == "prior":
        space = atom_num.get_space_size(protein_pos)
        sizes = np.array([atom_num.sample_atom_num(space, rng) for _ in range(n)])
    elif mode == "range":
        sizes = np.arange(start_index + 1, start_index + n + 1)
    elif mode == "ref":
        if ref_size is None:
            raise ValueError("mode 'ref' needs ref_size")
        sizes = np.full(n, ref_size)
    else:
        raise ValueError(mode)
    return np.clip(sizes, 1, max_ligand).astype(np.int64)


def sample_diffusion_ligand(
    model: DiffusionModel,
    pocket: Dict[str, np.ndarray],  # {'protein_pos': [NP,3], 'protein_feat': [NP,FP]}
    num_samples: int,
    generator: torch.Generator,
    batch_size: int = 100,
    num_steps: Optional[int] = None,
    sample_num_atoms: str = "prior",
    ref_size: Optional[int] = None,
    max_protein: Optional[int] = None,
    max_ligand: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, Any]:
    """Generate `num_samples` molecules for one pocket on `model.device`.
    Returns per-sample numpy 'pos' [n_atoms, 3] and 'v' [n_atoms] lists and
    the host seconds of each batch ('time', ending in a device-to-host copy)."""
    max_protein = max_protein or model.max_protein
    max_ligand = max_ligand or model.max_ligand
    rng = rng or np.random.default_rng(0)
    ppos = np.asarray(pocket["protein_pos"], np.float32)
    pfeat = np.asarray(pocket["protein_feat"], np.float32)
    n_prot = len(ppos)
    if n_prot > max_protein:
        raise ValueError(f"pocket has {n_prot} atoms but max_protein={max_protein}")
    np_pad = min(max_protein, -(-n_prot // 64) * 64)
    dev = model.device
    ppad = torch.zeros((np_pad, 3), device=dev)
    fpad = torch.zeros((np_pad, pfeat.shape[-1]), device=dev)
    ppad[:n_prot] = torch.as_tensor(ppos, device=dev)
    fpad[:n_prot] = torch.as_tensor(pfeat, device=dev)

    all_pos: List[np.ndarray] = []
    all_v: List[np.ndarray] = []
    time_list: List[float] = []
    done = 0
    while done < num_samples:
        n = min(batch_size, num_samples - done)
        sizes = sample_ligand_sizes(ppos, n, sample_num_atoms, ref_size=ref_size,
                                    max_ligand=max_ligand, rng=rng, start_index=done)
        pmask = torch.zeros((n, np_pad), dtype=torch.bool, device=dev)
        pmask[:, :n_prot] = True
        batch = ComplexBatch(
            protein_pos=ppad.expand(n, -1, -1).contiguous(),
            protein_feat=fpad.expand(n, -1, -1).contiguous(),
            protein_mask=pmask,
            ligand_pos=torch.zeros((n, max_ligand, 3), device=dev),
            ligand_v=torch.zeros((n, max_ligand), dtype=torch.long, device=dev),
            ligand_mask=torch.as_tensor(np.arange(max_ligand)[None, :] < sizes[:, None], device=dev),
        )
        init_pos, init_v = init_ligand_state(batch, model.num_classes, generator)
        t1 = time.perf_counter()
        res = model.sample_diffusion(batch, init_pos, init_v, generator, num_steps=num_steps)
        pos_np = res.pos.double().cpu().numpy()
        v_np = res.v.cpu().numpy()
        time_list.append(time.perf_counter() - t1)
        for i in range(n):
            s = int(sizes[i])
            all_pos.append(pos_np[i, :s])
            all_v.append(v_np[i, :s])
        done += n
    return {"pos": all_pos, "v": all_v, "time": time_list}
