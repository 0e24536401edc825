"""kNN graph: the CUDA kernels of csrc/knn.cu for CUDA tensors (one pass of
a warp-resident top-K for k <= 32, K argmin rounds above), the plain
`ops.graph.knn_graph` for CPU tensors. Replaces
targetdiff_tpu/ops/pallas/knn.py (`knn_graph_pallas`). The kernels' idx and
mask equal `ops.graph.knn_graph_exact` bit for bit."""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import graph as G
from . import build

LAUNCHES = 0  # kernel launches since the last reset (plain CPU calls not counted)


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.load_library()
    fn = lib.td_knn
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    max_nodes = lib.td_knn_max_nodes
    max_nodes.argtypes, max_nodes.restype = [ctypes.c_int], ctypes.c_int
    return fn, max_nodes


def knn_graph(pos: torch.Tensor, mask: torch.Tensor, k: int) -> G.Neighborhood:
    """pos [B,N,3] f32, mask [B,N] bool -> Neighborhood(idx [B,N,k] int64,
    mask [B,N,k] bool). Same selection as ops.graph.knn_graph: nearest
    first, ties to the lower index, masked slots with indices in [0, N)."""
    if pos.device.type == "cpu":
        return G.knn_graph(pos, mask, k)
    return knn_graph_cuda(pos, mask, k)


def knn_graph_cuda(pos: torch.Tensor, mask: torch.Tensor, k: int) -> G.Neighborhood:
    global LAUNCHES
    build.require_cuda(pos, "pos")
    B, N, three = pos.shape
    if three != 3 or pos.dtype != torch.float32:
        raise ValueError(f"pos must be float32 [B, N, 3], got {pos.dtype} {tuple(pos.shape)}")
    if mask.shape != (B, N) or mask.dtype != torch.bool or mask.device != pos.device:
        raise ValueError(f"mask must be bool [B, N] on {pos.device}")
    if not 0 < k <= N:
        raise ValueError(f"k={k} must lie in [1, N={N}]")
    knn, max_nodes = _entries()
    if N > max_nodes(k):
        raise ValueError(f"the kNN kernel for k={k} takes N <= {max_nodes(k)} nodes, got N={N}")
    pos, mask = pos.contiguous(), mask.contiguous()
    idx = torch.empty((B, N, k), dtype=torch.int64, device=pos.device)
    nmask = torch.empty((B, N, k), dtype=torch.bool, device=pos.device)
    status = knn(pos.data_ptr(), mask.data_ptr(), B, N, k, idx.data_ptr(), nmask.data_ptr(),
                 build.stream_ptr(pos.device))
    build.check(status, "td_knn")
    LAUNCHES += 1
    return G.Neighborhood(idx=idx, mask=nmask)
