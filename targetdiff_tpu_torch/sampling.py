"""Pocket-conditioned sampling pipeline, counterpart of
targetdiff_tpu/sampling.py (reference: scripts/sample_diffusion.py:31-116).

One pocket is padded once and replicated across the batch; ligand sizes come
from the atom-count prior on the host and become masks; init positions are
the pocket's centre of mass plus N(0, 1) and init types are uniform (or,
position-only, the reference ligand's). All noise is drawn from the caller's
`torch.Generator`. `sample_testset` samples many pockets from a pocket bank
uploaded once, a bounded number of rows at a time, on one device or with
each chunk's rows split over the ranks of a process group.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .data.batch import ComplexBatch
from .models.score_model import DiffusionModel
from .parallel.mesh import Mesh, gather_rows, row_range, shard_rows
from .utils import atom_num


def init_ligand_state(batch: ComplexBatch, num_classes: int, generator: torch.Generator,
                      pos_only: bool = False):
    """(init_pos [B,NL,3], init_v [B,NL]): the pocket's centre of mass plus
    N(0, 1), and uniform types, or under pos_only the batch's own types
    (reference: scripts/sample_diffusion.py:60-70)."""
    m = batch.protein_mask.float()[..., None]
    com = (batch.protein_pos * m).sum(1, keepdim=True) / m.sum(1, keepdim=True).clamp(min=1.0)
    dev = batch.device
    init_pos = com + torch.randn(batch.ligand_pos.shape, generator=generator, device=dev)
    if pos_only:
        return init_pos, batch.ligand_v
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


def choose_protein_padding(np_max: int, max_protein: int, max_ligand: int) -> int:
    """Protein padding for a bank of pockets: the next multiple of 64 above
    the largest pocket, at most `max_protein` (targetdiff_tpu/sampling.py:76)."""
    if np_max > max_protein:
        raise ValueError(f"largest pocket has {np_max} atoms but max_protein={max_protein}")
    return min(max_protein, -(-np_max // 64) * 64)


def sample_diffusion_ligand(
    model: DiffusionModel,
    pocket: Dict[str, np.ndarray],  # {'protein_pos': [NP,3], 'protein_feat': [NP,FP]}
    num_samples: int,
    generator: torch.Generator,
    batch_size: int = 100,
    num_steps: Optional[int] = None,
    pos_only: bool = False,
    center_pos_mode: str = "protein",
    sample_num_atoms: str = "prior",
    ref_ligand: Optional[Dict[str, np.ndarray]] = None,  # for mode 'ref' and pos_only
    max_protein: Optional[int] = None,
    max_ligand: Optional[int] = None,
    return_traj: bool = False,
    traj_stride: int = 1,
    rng: Optional[np.random.Generator] = None,
    sampler: str = "ddpm",
    eta: float = 0.0,
    ddim_spacing: str = "uniform",
    dtype=torch.bfloat16,
) -> Dict[str, Any]:
    """Generate `num_samples` molecules for one pocket on `model.device`
    (targetdiff_tpu/sampling.py:sample_diffusion_ligand). Returns per-sample
    numpy 'pos' [n_atoms, 3] and 'v' [n_atoms] lists, the host seconds of
    each batch ('time', ending in a device-to-host copy) and, with
    return_traj, 'pos_traj' [frames, n_atoms, 3] and 'v_traj' [frames,
    n_atoms], every `traj_stride`-th step, copied from the device once a
    batch. Mode 'ref' and pos_only take the size and the types of
    `ref_ligand` ({'ligand_pos', 'ligand_v'}); sampler, eta, ddim_spacing
    and dtype (bf16 by default, as the JAX package samples) as in
    DiffusionModel.sample_diffusion."""
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
    ligand_v = torch.zeros((max_ligand,), dtype=torch.long, device=dev)
    if pos_only and ref_ligand is not None:
        ref_v = np.asarray(ref_ligand["ligand_v"])
        ligand_v[:len(ref_v)] = torch.as_tensor(ref_v, device=dev)

    out: Dict[str, List] = {"pos": [], "v": [], "pos_traj": [], "v_traj": [], "time": []}
    done = 0
    while done < num_samples:
        n = min(batch_size, num_samples - done)
        sizes = sample_ligand_sizes(
            ppos, n, sample_num_atoms, max_ligand=max_ligand, rng=rng, start_index=done,
            ref_size=None if ref_ligand is None else len(ref_ligand["ligand_pos"]))
        pmask = torch.zeros((n, np_pad), dtype=torch.bool, device=dev)
        pmask[:, :n_prot] = True
        batch = ComplexBatch(
            protein_pos=ppad.expand(n, -1, -1).contiguous(),
            protein_feat=fpad.expand(n, -1, -1).contiguous(),
            protein_mask=pmask,
            ligand_pos=torch.zeros((n, max_ligand, 3), device=dev),
            ligand_v=ligand_v.expand(n, -1).contiguous(),
            ligand_mask=torch.as_tensor(np.arange(max_ligand)[None, :] < sizes[:, None], device=dev),
        )
        init_pos, init_v = init_ligand_state(batch, model.num_classes, generator, pos_only)
        t1 = time.perf_counter()
        res = model.sample_diffusion(batch, init_pos, init_v, generator, num_steps=num_steps,
                                     center_pos_mode=center_pos_mode, pos_only=pos_only,
                                     return_traj=return_traj, sampler=sampler, eta=eta,
                                     ddim_spacing=ddim_spacing, dtype=dtype)
        pos_np = res.pos.double().cpu().numpy()
        v_np = res.v.cpu().numpy()
        if return_traj:
            pos_traj = res.pos_traj[::traj_stride].double().cpu().numpy()
            v_traj = res.v_traj[::traj_stride].cpu().numpy()
        out["time"].append(time.perf_counter() - t1)
        for i, size in enumerate(sizes.tolist()):
            out["pos"].append(pos_np[i, :size])
            out["v"].append(v_np[i, :size])
            if return_traj:
                out["pos_traj"].append(pos_traj[:, i, :size])
                out["v_traj"].append(v_traj[:, i, :size])
        done += n
    return out


def sample_testset(
    model: DiffusionModel,
    pockets: List[Dict[str, np.ndarray]],
    num_samples_per_pocket: int,
    generator: torch.Generator,
    num_steps: Optional[int] = None,
    sample_num_atoms: str = "prior",
    max_protein: Optional[int] = None,
    max_ligand: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
    chunk_rows: int = 100,
    ref_sizes: Optional[List[int]] = None,
    sampler: str = "ddpm",
    eta: float = 0.0,
    ddim_spacing: str = "uniform",
    mesh: Optional[Mesh] = None,
    dtype=torch.bfloat16,
) -> List[Dict[str, Any]]:
    """`num_samples_per_pocket` molecules for each of `pockets` on
    `model.device`: the counterpart of
    targetdiff_tpu/sampling.py:sample_testset_sharded (reference:
    scripts/batch_sample_diffusion.sh). The pockets are uploaded once, as a
    bank [P, NPpad, *]; the pocket x sample rows run `chunk_rows` at a time,
    each chunk's batch gathered on the device from the bank, so peak memory
    is set by `chunk_rows`, not by the number of pockets. Mode 'ref' takes
    one reference ligand size per pocket in `ref_sizes`; sampler, eta,
    ddim_spacing and dtype (bf16 by default) as in
    DiffusionModel.sample_diffusion.

    With a `mesh` (parallel/mesh.py), the rows of each chunk are split over
    the ranks (`chunk_rows` rounded down to a multiple of W; a last chunk
    may split unequally). Every rank builds the same bank and row sizes
    from the same `rng` and draws each chunk's noise at the chunk's shape
    from a generator seeded alike, samples its rows and gathers the rest,
    so every rank returns the one-process result.

    Returns one dict per pocket: 'pos' and 'v' lists of numpy arrays, and
    'time', the host seconds of the chunks it shared, split by its share of
    each chunk's rows (each chunk's clock ends in a device-to-host copy)."""
    max_protein = max_protein or model.max_protein
    max_ligand = max_ligand or model.max_ligand
    rng = rng or np.random.default_rng(0)
    if sample_num_atoms == "ref" and ref_sizes is None:
        raise ValueError("sample_num_atoms='ref' needs ref_sizes, one per pocket")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    if mesh is not None:
        chunk_rows = max(mesh.world, chunk_rows // mesh.world * mesh.world)
    P, S = len(pockets), num_samples_per_pocket
    rows = P * S
    dev = model.device

    fp = pockets[0]["protein_feat"].shape[-1]
    np_pad = choose_protein_padding(max(len(p["protein_pos"]) for p in pockets), max_protein,
                                    max_ligand)
    bank_pos = np.zeros((P, np_pad, 3), np.float32)
    bank_feat = np.zeros((P, np_pad, fp), np.float32)
    bank_len = np.zeros((P,), np.int64)
    row_sizes = np.ones((rows,), np.int64)
    for pi, pocket in enumerate(pockets):
        pp = np.asarray(pocket["protein_pos"], np.float32)
        bank_pos[pi, :len(pp)] = pp
        bank_feat[pi, :len(pp)] = np.asarray(pocket["protein_feat"], np.float32)
        bank_len[pi] = len(pp)
        row_sizes[pi * S:(pi + 1) * S] = sample_ligand_sizes(
            pp, S, sample_num_atoms, max_ligand=max_ligand, rng=rng,
            ref_size=None if ref_sizes is None else ref_sizes[pi])
    row_pocket = np.repeat(np.arange(P), S)
    bank_pos_d = torch.as_tensor(bank_pos, device=dev)
    bank_feat_d = torch.as_tensor(bank_feat, device=dev)
    bank_len_d = torch.as_tensor(bank_len, device=dev)
    slots = torch.arange(np_pad, device=dev)

    pos_out: List[np.ndarray] = [None] * rows
    v_out: List[np.ndarray] = [None] * rows
    pocket_time = np.zeros((P,), np.float64)
    for start in range(0, rows, chunk_rows):
        idx = np.arange(start, min(start + chunk_rows, rows))
        ids = torch.as_tensor(row_pocket[idx], device=dev)
        szs = row_sizes[idx]
        C = len(idx)
        batch = ComplexBatch(
            protein_pos=bank_pos_d[ids],
            protein_feat=bank_feat_d[ids],
            protein_mask=slots[None, :] < bank_len_d[ids][:, None],
            ligand_pos=torch.zeros((C, max_ligand, 3), device=dev),
            ligand_v=torch.zeros((C, max_ligand), dtype=torch.long, device=dev),
            ligand_mask=torch.as_tensor(np.arange(max_ligand)[None, :] < szs[:, None],
                                        device=dev),
        )
        init_pos, init_v = init_ligand_state(batch, model.num_classes, generator)
        start_row, stop_row = (0, C) if mesh is None else row_range(C, mesh)
        if mesh is not None:
            batch = shard_rows(batch, mesh, even=False)
            init_pos, init_v = init_pos[start_row:stop_row], init_v[start_row:stop_row]
        t1 = time.perf_counter()
        res = model.sample_diffusion(batch, init_pos, init_v, generator, num_steps=num_steps,
                                     sampler=sampler, eta=eta, ddim_spacing=ddim_spacing,
                                     noise_rows=(C, start_row, stop_row), dtype=dtype)
        pos, v = res.pos, res.v
        if mesh is not None:
            pos, v = gather_rows(pos, C, mesh), gather_rows(v, C, mesh)
        pos_np = pos.double().cpu().numpy()
        v_np = v.cpu().numpy()
        chunk_t = time.perf_counter() - t1
        for pi, cnt in zip(*np.unique(row_pocket[idx], return_counts=True)):
            pocket_time[pi] += chunk_t * cnt / C
        for ci, r in enumerate(idx):
            pos_out[r] = pos_np[ci, :szs[ci]]
            v_out[r] = v_np[ci, :szs[ci]]

    return [{"pos": pos_out[pi * S:(pi + 1) * S], "v": v_out[pi * S:(pi + 1) * S],
             "time": float(pocket_time[pi])} for pi in range(P)]
