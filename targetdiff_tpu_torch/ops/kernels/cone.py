"""The sampler's dependency cone: which rows each layer of a block must
compute when only the ligand outputs are read (`need_full_h=False`). The
CUDA kernel of csrc/cone.cu (`cone_kernel`, two launches) for CUDA tensors,
the plain PyTorch version for CPU tensors. Replaces the per-layer liveness
of targetdiff_tpu/ops/pallas/block_denoiser.py:compute_tile_flags
(`num_layers=L`) at the granularity of rows, the rule whose tiles that
function marks.

hop(r) is the reverse-kNN distance from row r to the ligand: 0 on every
ligand-tail row (the last `n_ligand` rows of a complex, masked or not), then
hop(s) = 1 + min hop(d) over the valid edges d <- s (row d lists s as a
neighbour), capped at L + 1; unreached rows get L + 2. In a block of L
layers, layer l (0-based) needs its x2h output (and the destination
projections ni, q) on the rows with hop <= L - l and the source projections
nj on the rows with hop <= L - l + 1; the h2x pass needs ni and q on the
ligand rows (hop 0) and nj on hop <= 1. The sets shrink with l, so a row
skipped once is never read again, and the ligand outputs equal those of a
block that computes every row. At l = L - 1 the rule is JAX's v9
"last-x2h" row rule: ligand rows and the valid sources of their edges.

A `Cone` holds hop [B, N], `order` [B*N] (the rows b*N + i sorted by hop,
ties by row: the rows of hop <= k are order[:counts[k]]) and `counts`
[L + 2] (int32, on the graph's device). The block kernels read their row
counts from `counts` on the device: computing the cone needs no host
synchronisation.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

LAUNCHES = 0  # cone_cuda calls (each two kernel launches) since the last reset
MAX_LAYERS = 29  # hop values 0 .. L + 2 fit the kernel's 32 bins


class Cone(NamedTuple):
    """The dependency cone of one block call of `num_layers` layers."""

    hop: torch.Tensor     # [B, N] int32
    order: torch.Tensor   # [B*N] int32, rows b*N + i by hop, ties by row
    counts: torch.Tensor  # [L + 2] int32, counts[k] = rows of hop <= k

    @property
    def num_layers(self) -> int:
        return self.counts.shape[0] - 2

    def rows(self, k: int) -> torch.Tensor:
        """The rows b*N + i of hop <= k (a host read of counts[k])."""
        return self.order[:int(self.counts[k])]

    def x2h_rows(self, layer: int) -> torch.Tensor:
        """The rows whose x2h output layer `layer` computes: hop <= L - layer."""
        return self.rows(self.num_layers - layer)

    def node_rows(self, layer: int) -> torch.Tensor:
        """The rows whose source projections layer `layer` reads: hop <= L - layer + 1."""
        return self.rows(self.num_layers - layer + 1)


def _check(idx, nbr_mask, n_ligand: int, num_layers: int):
    B, N, K = idx.shape
    if nbr_mask.shape != (B, N, K) or nbr_mask.dtype != torch.bool:
        raise ValueError("nbr_mask must be bool of idx's shape [B, N, K]")
    if not 0 < n_ligand <= N:
        raise ValueError(f"n_ligand={n_ligand} must lie in [1, N={N}]")
    if not 0 < num_layers <= MAX_LAYERS:
        raise ValueError(f"num_layers={num_layers} must lie in [1, {MAX_LAYERS}]")


def cone_hops_plain(idx, nbr_mask, n_ligand: int, num_layers: int) -> torch.Tensor:
    """hop [B, N] int32 of the graph idx [B, N, K] / nbr_mask [B, N, K]: L + 1
    sweeps of a scatter-min over the valid edges."""
    _check(idx, nbr_mask, n_ligand, num_layers)
    B, N, K = idx.shape
    L = num_layers
    far = L + 2
    hop = torch.full((B, N), far, dtype=torch.int64, device=idx.device)
    hop[:, N - n_ligand:] = 0
    src = idx.reshape(B, N * K)
    for _ in range(L + 1):
        cand = torch.where(nbr_mask, hop[:, :, None] + 1, far).reshape(B, N * K)
        hop = hop.scatter_reduce(1, src, cand, reduce="amin")
    return hop.clamp(max=far).to(torch.int32)


def cone_plain(idx, nbr_mask, n_ligand: int, num_layers: int) -> Cone:
    """The plain version of `cone_cuda`: hops, their stable order and counts."""
    hop = cone_hops_plain(idx, nbr_mask, n_ligand, num_layers)
    order = torch.argsort(hop.reshape(-1), stable=True).to(torch.int32)
    k = torch.arange(num_layers + 2, device=hop.device)
    counts = (hop.reshape(-1)[None, :] <= k[:, None]).sum(-1).to(torch.int32)
    return Cone(hop, order, counts)


def block_cone(idx, nbr_mask, n_ligand: int, num_layers: int) -> Cone:
    """The cone of a graph: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if idx.device.type == "cpu":
        return cone_plain(idx, nbr_mask, n_ligand, num_layers)
    return cone_cuda(idx, nbr_mask, n_ligand, num_layers)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load_library().td_cone
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # idx, nmask, B, N, K, n_ligand, L, hop, order, counts, hist, stream
    fn.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp, vp, vp, vp, vp]
    fn.restype = ctypes.c_int
    return fn


def cone_cuda(idx, nbr_mask, n_ligand: int, num_layers: int) -> Cone:
    """`cone_kernel` (csrc/cone.cu) on idx [B, N, K] int64 and nbr_mask bool,
    CUDA tensors; `cone_plain` is its plain version."""
    global LAUNCHES
    build.require_cuda(idx, "idx")
    _check(idx, nbr_mask, n_ligand, num_layers)
    if idx.dtype != torch.int64 or nbr_mask.device != idx.device:
        raise ValueError(f"idx must be int64 with nbr_mask on {idx.device}")
    B, N, K = idx.shape
    L = num_layers
    idx, nmask = idx.contiguous(), nbr_mask.contiguous()
    # one allocation: hop, order, counts, the per-complex histograms
    work = torch.empty(2 * B * N + L + 2 + B * (L + 3), dtype=torch.int32, device=idx.device)
    hop, order = work[:B * N], work[B * N:2 * B * N]
    counts, hist = work[2 * B * N:2 * B * N + L + 2], work[2 * B * N + L + 2:]
    build.check(_entry()(idx.data_ptr(), nmask.data_ptr(), B, N, K, n_ligand, L,
                         hop.data_ptr(), order.data_ptr(), counts.data_ptr(), hist.data_ptr(),
                         build.stream_ptr(idx.device)), "td_cone")
    LAUNCHES += 1
    return Cone(hop.view(B, N), order, counts)
