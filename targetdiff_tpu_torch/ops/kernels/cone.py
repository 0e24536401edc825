"""The sampler's dependency cone: which rows each layer of a block must
compute when only the ligand outputs are read (`need_full_h=False`). The
CUDA kernel of csrc/cone.cu (`cone_kernel`, one cooperative launch) for
CUDA tensors, the plain PyTorch version for CPU tensors. Replaces the
per-layer liveness of targetdiff_tpu/ops/pallas/block_denoiser.py:
compute_tile_flags (`num_layers=L`) at the granularity of rows, the rule
whose tiles that function marks.

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
synchronisation. A call given a `ConeWorkspace` writes its Cone into the
workspace's buffer (the sampling loop keeps one a run) and allocates
nothing once the buffer is large enough; that Cone lives until the
workspace's next call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

LAUNCHES = 0  # cone_kernel launches (one a cone_cuda call) since the last reset
MAX_LAYERS = 29  # hop values 0 .. L + 2 fit the kernel's 32 bins
MAX_ROWS = 65535  # the kernel's rows a complex: its row lists are uint16
# cone_phase_cycles: the adjacency bitsets (the whole card's, for a small
# batch) and the barrier after them, a complex's bitsets into shared memory,
# its sweeps, the second barrier, the placement
PHASES = ("adjacency", "adjacency_barrier", "bitsets", "sweeps", "grid_barrier", "placement")


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


def _adj_words(N: int) -> int:
    """int32 elements of one complex's adjacency bitsets in the kernel's
    scratch: N rows of ceil(N / 32) words, padded to 16 bytes (csrc/cone.cu
    adj_words; N = 608: 46 KB, N = 4000: 2 MB)."""
    return -(-N * -(-N // 32) // 4) * 4


def _words(B: int, N: int, L: int) -> int:
    return B * _adj_words(N) + (B * N + 1) // 2 + 2 * B * N + L + 2 + B * (L + 3)


def _carve(work: torch.Tensor, B: int, N: int, L: int):
    """The Cone and the kernel's scratch as views of one int32 buffer: the
    adjacency bitsets first (16-byte aligned), the complexes' rows by hop
    (uint16), then hop, order, counts and the complexes' histograms [B, L +
    3]."""
    adj = B * _adj_words(N)
    at = adj + (B * N + 1) // 2
    rows = B * N
    hop, order = work[at:at + rows], work[at + rows:at + 2 * rows]
    counts = work[at + 2 * rows:at + 2 * rows + L + 2]
    hist = work[at + 2 * rows + L + 2:at + 2 * rows + L + 2 + B * (L + 3)]
    return Cone(hop.view(B, N), order, counts), (hist, work[:adj], work[adj:at])


class ConeWorkspace:
    """One int32 buffer for the cones of a run (the sampling loop's): a call
    given it writes its Cone there, growing the buffer only when a larger
    batch needs it, and reuses the views of the previous call's shape. The
    Cone of a call lives until the next."""

    def __init__(self):
        self.buffer = None
        self._last = None  # (shape key, Cone, scratch)

    def take(self, B: int, N: int, L: int, device):
        """(Cone, scratch) views for B complexes of N rows and L layers."""
        key = (B, N, L, device)
        if self._last is not None and self._last[0] == key:
            return self._last[1:]
        if (self.buffer is None or self.buffer.device != device
                or self.buffer.numel() < _words(B, N, L)):
            self.buffer = torch.empty(_words(B, N, L), dtype=torch.int32, device=device)
        self._last = (key, *_carve(self.buffer, B, N, L))
        return self._last[1:]


def block_cone(idx, nbr_mask, n_ligand: int, num_layers: int,
               workspace: ConeWorkspace | None = None) -> Cone:
    """The cone of a graph: the kernel for CUDA tensors, the plain version for
    CPU tensors (copied into `workspace`'s buffer when one is given)."""
    if idx.device.type == "cpu":
        cone = cone_plain(idx, nbr_mask, n_ligand, num_layers)
        if workspace is None:
            return cone
        out, _ = workspace.take(*idx.shape[:2], num_layers, idx.device)
        for dst, src in zip(out, cone):
            dst.copy_(src)
        return out
    return cone_cuda(idx, nbr_mask, n_ligand, num_layers, workspace)


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.load_library()
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # idx, nmask, B, N, K, n_ligand, L, hop, order, counts, hist, adj, rowlist, stamps, stream
    lib.td_cone.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.td_cone.restype = ctypes.c_int
    # B, N, out[7]
    lib.td_cone_grid.argtypes = [i32, i32, vp]
    lib.td_cone_grid.restype = ctypes.c_int
    return lib.td_cone, lib.td_cone_grid


def _check_cuda(idx, nbr_mask, n_ligand: int, num_layers: int):
    build.require_cuda(idx, "idx")
    _check(idx, nbr_mask, n_ligand, num_layers)
    if idx.dtype != torch.int64 or nbr_mask.device != idx.device:
        raise ValueError(f"idx must be int64 with nbr_mask on {idx.device}")
    if idx.shape[1] > MAX_ROWS:
        raise ValueError(f"cone_kernel takes at most {MAX_ROWS} rows a complex, "
                         f"got N={idx.shape[1]}")
    return idx.contiguous(), nbr_mask.contiguous()


def _launch(idx, nmask, n_ligand, L, cone, scratch, stamps=None):
    B, N, K = idx.shape
    hist, adj, rowlist = scratch
    build.check(_entries()[0](idx.data_ptr(), nmask.data_ptr(), B, N, K, n_ligand, L,
                              cone.hop.data_ptr(), cone.order.data_ptr(),
                              cone.counts.data_ptr(), hist.data_ptr(), adj.data_ptr(),
                              rowlist.data_ptr(), None if stamps is None else stamps.data_ptr(),
                              build.stream_ptr(idx.device)), "td_cone")


def _fresh(idx, L):
    B, N, _ = idx.shape
    return _carve(torch.empty(_words(B, N, L), dtype=torch.int32, device=idx.device), B, N, L)


def cone_cuda(idx, nbr_mask, n_ligand: int, num_layers: int,
              workspace: ConeWorkspace | None = None) -> Cone:
    """`cone_kernel` (csrc/cone.cu) on idx [B, N, K] int64 and nbr_mask bool,
    CUDA tensors; `cone_plain` is its plain version. With a `workspace` the
    Cone and the kernel's scratch are written into its buffer, else into a
    fresh allocation."""
    global LAUNCHES
    idx, nmask = _check_cuda(idx, nbr_mask, n_ligand, num_layers)
    cone, scratch = (_fresh(idx, num_layers) if workspace is None
                     else workspace.take(*idx.shape[:2], num_layers, idx.device))
    _launch(idx, nmask, n_ligand, num_layers, cone, scratch)
    LAUNCHES += 1
    return cone


def cone_grid(B: int, N: int) -> dict:
    """The launch `cone_cuda` makes for B complexes of N rows on the current
    card: its grid (the co-resident blocks), blocks an SM, whether the
    adjacency bitsets are cached in shared memory, shared bytes a block, a
    complex's uint32 adjacency words in the scratch, int64 stamps a block,
    and whether the whole card builds the bitsets (a small batch, or
    bitsets too large for shared memory)."""
    out = (ctypes.c_int * 7)()
    build.check(_entries()[1](B, N, out), "td_cone_grid")
    return {"grid": out[0], "blocks_per_sm": out[1], "cached": bool(out[2]),
            "smem_bytes": out[3], "adj_words": out[4], "stamp_words": out[5],
            "spread": bool(out[6])}


def cone_phase_cycles(idx, nbr_mask, n_ligand: int, num_layers: int) -> dict:
    """One launch of the stamped `cone_kernel` (a measurement, not counted in
    LAUNCHES): each block's clock64 cycles in each of PHASES, the largest
    and the mean over the grid's blocks; for complex 0, each sweep k = 1 ..
    L + 1 that ran: its cycles and its level's rows; and the Cone, which
    equals `cone_cuda`'s."""
    idx, nmask = _check_cuda(idx, nbr_mask, n_ligand, num_layers)
    launch = cone_grid(*idx.shape[:2])
    cone, scratch = _fresh(idx, num_layers)
    stamps = torch.zeros((launch["grid"], launch["stamp_words"]), dtype=torch.int64,
                         device=idx.device)
    _launch(idx, nmask, n_ligand, num_layers, cone, scratch, stamps)
    cycles = stamps.cpu().double()
    phases, sweeps = cycles[:, :len(PHASES)], cycles[0, len(PHASES):].view(2, -1)
    ran = [k for k in range(1, num_layers + 2) if sweeps[0, k] > 0]
    return {"grid": launch["grid"], "cone": cone,
            "max_cycles": dict(zip(PHASES, phases.max(0).values.tolist())),
            "mean_cycles": dict(zip(PHASES, phases.mean(0).tolist())),
            "sweeps": {name: [sweeps[j, k].item() for k in ran]
                       for j, name in enumerate(("cycles", "new_rows"))}}
