"""The training backward's inverse adjacency (csrc/pass_bwd.cuh
build_adjacency, a stable counting sort over edge tiles) on the CPU:
`block_vjp.adjacency_plain` against a naive loop, and a replay of the
kernels' tiled counting sort (per-tile counts, the scan in (source, tile)
order, ranks of 32-edge steps as __match_any_sync gives them) against
`adjacency_plain`, on kNN graphs of K = 8 and 32 and hybrid graphs of K = 15
and 40, for the x2h pass (row0 = 0) and the h2x pass (row0 = N - n_ligand)."""

import numpy as np
import pytest
import torch

from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels import block_vjp

B, NP_ = 3, 40


def kernel_tile(n):
    """Edges per tile of build_adjacency at n nodes (csrc/pass_bwd.cuh
    adj_tile_edges): at least 512 and at least n, a multiple of 32."""
    return -(-max(n, 512) // 32) * 32


def _graph(kind, k, seed=0):
    """(idx, nmask, n_ligand): a kNN graph (k neighbours) or a hybrid graph
    (k = max_ligand - 1 + knn) over B complexes of NP_ protein slots and
    8 or 9 ligand slots, with padded rows; "repeats": random indices with
    sources repeated within rows, half the slots valid."""
    rng = np.random.default_rng(seed)
    n_lig = {15: 8, 40: 9}.get(k, 8) if kind == "hybrid" else 8
    N = NP_ + n_lig
    pos = torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float32) * 3)
    mask = torch.ones((B, N), dtype=torch.bool)
    mask[0, 30:NP_] = False  # padded protein slots
    mask[1, NP_ + 5:] = False  # padded ligand slots
    mask[2, ::7] = False
    if kind == "knn":
        nbh = G.knn_graph_exact(pos, mask, k)
        return nbh.idx, nbh.mask, n_lig
    if kind == "hybrid":
        mlig = mask.clone()
        mlig[:, :NP_] = False
        nbh = G.hybrid_graph(pos, mask, mlig, k - (n_lig - 1), n_lig)
        assert nbh.idx.shape[-1] == k
        return nbh.idx, nbh.mask, n_lig
    idx = torch.from_numpy(rng.integers(0, 6, size=(B, N, k)))
    return idx, torch.from_numpy(rng.random((B, N, k)) < 0.5), n_lig


def _naive(idx, nmask, row0):
    B, N, K = idx.shape
    offs, lists = [], []
    for b in range(B):
        groups = [[] for _ in range(N)]
        for i in range(row0, N):
            for k in range(K):
                if nmask[b, i, k]:
                    groups[int(idx[b, i, k])].append((i - row0) * K + k)
        offs.append(np.cumsum([0] + [len(g) for g in groups]))
        lists.append([u for g in groups for u in g])
    return offs, lists


def replay_counting_sort(idx, nmask, row0, tile):
    """build_adjacency's three kernels in numpy: (off [B, N+1], list [B, E]),
    list's slots past off[b, N] -1 (the kernel leaves them unwritten)."""
    idx, nmask = idx.numpy(), nmask.numpy()
    B, N, K = idx.shape
    E = (N - row0) * K
    nt = -(-E // tile)
    src = idx[:, row0:].reshape(B, E)
    valid = nmask[:, row0:].reshape(B, E)
    off = np.zeros((B, N + 1), np.int32)
    out = np.full((B, E), -1, np.int32)
    for b in range(B):
        # adj_count_kernel: each tile's valid edges per source
        cnt = np.zeros((nt, N), np.int64)
        for u in range(E):
            if valid[b, u]:
                cnt[u // tile, src[b, u]] += 1
        # adj_scan_kernel: exclusive scan in (source, tile) order
        flat = cnt.T.reshape(-1)
        start = (np.cumsum(flat) - flat).reshape(N, nt).T
        off[b, :N], off[b, N] = start[0], flat.sum()
        # adj_place_kernel: 32 edges a step, ranks among the step's edges
        # of the same source (lanes below, as __match_any_sync's peers)
        nxt = start.copy()
        for t in range(nt):
            for s in range(t * tile, min(t * tile + tile, E), 32):
                lanes = [u for u in range(s, min(s + 32, t * tile + tile, E)) if valid[b, u]]
                for u in lanes:
                    j = src[b, u]
                    rank = sum(1 for w in lanes if w < u and src[b, w] == j)
                    out[b, nxt[t, j] + rank] = u
                for j in {src[b, u] for u in lanes}:
                    nxt[t, j] += sum(1 for u in lanes if src[b, u] == j)
    return off, out


CASES = [("knn", 8), ("knn", 32), ("hybrid", 15), ("hybrid", 40), ("repeats", 12)]


@pytest.mark.parametrize("kind,k", CASES)
@pytest.mark.parametrize("h2x", [False, True])
def test_adjacency_plain_matches_naive_loop(kind, k, h2x):
    idx, nmask, n_lig = _graph(kind, k)
    N = idx.shape[1]
    row0 = N - n_lig if h2x else 0
    off, lst = block_vjp.adjacency_plain(idx, nmask, row0)
    assert off.dtype == lst.dtype == torch.int32 and lst.shape == (B, (N - row0) * k)
    want_off, want_lists = _naive(idx, nmask, row0)
    for b in range(B):
        n = int(off[b, N])
        np.testing.assert_array_equal(off[b].numpy(), want_off[b])
        np.testing.assert_array_equal(lst[b, :n].numpy(), want_lists[b])
        assert (lst[b, n:] == -1).all()


@pytest.mark.parametrize("kind,k", CASES)
@pytest.mark.parametrize("h2x", [False, True])
def test_counting_sort_replay_equals_plain(kind, k, h2x):
    """The kernels' tiled counting sort, at their own tile (one tile at
    these sizes) and at tiles of 32, 64 and 96 edges (many tiles, a source's
    edges spread over them), bitwise equal to adjacency_plain."""
    idx, nmask, n_lig = _graph(kind, k, seed=1)
    N = idx.shape[1]
    row0 = N - n_lig if h2x else 0
    off, lst = block_vjp.adjacency_plain(idx, nmask, row0)
    for tile in (kernel_tile(N), 32, 64, 96):
        r_off, r_lst = replay_counting_sort(idx, nmask, row0, tile)
        np.testing.assert_array_equal(r_off, off.numpy())
        np.testing.assert_array_equal(r_lst, lst.numpy())


def test_adjacency_cuda_refuses_cpu_tensors():
    idx, nmask, _ = _graph("knn", 8)
    with pytest.raises(ValueError, match="CUDA"):
        block_vjp.adjacency_cuda(idx, nmask, 0)
