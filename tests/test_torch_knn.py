"""The port's kNN graph (plain versions of the CUDA kernels csrc/knn.cu)
against the JAX package's Pallas kNN kernel in interpret mode and its XLA
knn_graph, on tie-free geometry with masked rows; and a replay of the
kernels' selection held bitwise to knn_graph_exact on tie-heavy geometry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from targetdiff_tpu.ops import graph as JG
from targetdiff_tpu.ops.pallas.knn import knn_graph_pallas
from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels.knn import knn_graph

torch.set_num_threads(2)

B, N, K = 3, 40, 8


def _inputs():
    rng = np.random.default_rng(0)
    pos = (rng.normal(size=(B, N, 3)) * 3).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[0, 30:] = False  # padded tail
    mask[1, ::7] = False  # scattered masked rows
    mask[2, 5:] = False  # fewer valid atoms than K + 1
    return pos, mask


def test_knn_matches_pallas_and_xla():
    pos, mask = _inputs()
    nbh = knn_graph(torch.from_numpy(pos), torch.from_numpy(mask), K)
    idx, nmask = nbh.idx.numpy(), nbh.mask.numpy()
    assert idx.dtype == np.int64 and idx.shape == (B, N, K)
    assert ((idx >= 0) & (idx < N)).all()

    p_idx, p_mask = knn_graph_pallas(jnp.asarray(pos), jnp.asarray(mask), k=K, interpret=True)
    x_nbh = JG.knn_graph(jnp.asarray(pos), jnp.asarray(mask), K)
    for ref_idx, ref_mask in ((p_idx, p_mask), (x_nbh.idx, x_nbh.mask)):
        ref_idx, ref_mask = np.asarray(ref_idx), np.asarray(ref_mask)
        np.testing.assert_array_equal(nmask, ref_mask)
        np.testing.assert_array_equal(np.where(nmask, idx, -1), np.where(ref_mask, ref_idx, -1))
    # row 2 has 4 valid neighbours per valid row, padded rows none
    assert nmask[2, :5].sum(-1).tolist() == [4] * 5 and not nmask[2, 5:].any()


def test_knn_exact_matches_pallas_and_xla():
    """knn_graph_exact (the kernel's rounding, the plain version the card's
    bitwise checks use) on the same tie-free inputs: valid slots equal to
    the Pallas kernel's and JAX knn_graph's (the Pallas kernel repeats
    indices in its masked slots)."""
    pos, mask = _inputs()
    nbh = G.knn_graph_exact(torch.from_numpy(pos), torch.from_numpy(mask), K)
    idx, nmask = nbh.idx.numpy(), nbh.mask.numpy()
    assert ((idx >= 0) & (idx < N)).all()
    p_idx, p_mask = knn_graph_pallas(jnp.asarray(pos), jnp.asarray(mask), k=K, interpret=True)
    x_nbh = JG.knn_graph(jnp.asarray(pos), jnp.asarray(mask), K)
    for ref_idx, ref_mask in ((p_idx, p_mask), (x_nbh.idx, x_nbh.mask)):
        ref_idx, ref_mask = np.asarray(ref_idx), np.asarray(ref_mask)
        np.testing.assert_array_equal(nmask, ref_mask)
        np.testing.assert_array_equal(np.where(nmask, idx, -1), np.where(ref_mask, ref_idx, -1))


# ---- a replay of csrc/knn.cu's selection, held to knn_graph_exact bit for bit ----

BIG32 = np.float32(1e20)
EMPTY = 2**40  # an index above every column: the kernel's empty key
WARP_K = 32  # csrc/knn.cu: knn_kernel (one warp's list) for k <= 32, knn_rounds_kernel above
MERGE_AT = 4  # csrc/knn.cu kMergeAt: survivors of a 32-column batch from which it is merged


def _kernel_d2(pos, mask):
    """[B, N, N] float32 squared distances as the kernel rounds them (one
    numpy float32 operation each), 1e20 on invalid and self pairs."""
    x, y, z = (pos[..., c] for c in range(3))
    sq = (x * x + y * y) + z * z
    cross = ((x[:, :, None] * x[:, None, :] + y[:, :, None] * y[:, None, :])
             + z[:, :, None] * z[:, None, :])
    d2 = np.maximum((sq[:, :, None] + sq[:, None, :]) - np.float32(2) * cross, np.float32(0))
    n = pos.shape[1]
    valid = mask[:, None, :] & mask[:, :, None] & ~np.eye(n, dtype=bool)
    return np.where(valid, d2, BIG32).astype(np.float32)


def _before(da, ja, db, jb):
    return (da < db) | ((da == db) & (ja < jb))


def _bitonic_step(d, j, s, ascending):
    """One compare-exchange of the warp network (knn.cu bitonic_step) over
    the 32 lanes at once; ascending is per lane."""
    lane = np.arange(32)
    od, oj = d[lane ^ s], j[lane ^ s]
    keep_min = ((lane & s) == 0) == ascending
    take = np.where(keep_min, _before(od, oj, d, j), _before(d, j, od, oj))
    return np.where(take, od, d), np.where(take, oj, j)


def _warp_row(row, i, k, merge_at):
    """knn_kernel on row i of d2: the 32-entry list, batches of 32 columns
    from the row's own (i // 32) on and around, the filter against the K-th
    (d2, j) key, then the batch's survivors compacted, sorted and merged
    (merge_at or more) or inserted in lane order. Returns the list's first
    k (j, d2)."""
    n = len(row)
    lane = np.arange(32)
    d = np.full(32, np.inf, np.float32)
    j = np.full(32, n)
    nb = -(-n // 32)
    for t in [(i // 32 + q) % nb for q in range(nb)]:
        cols = 32 * t + lane
        c = np.where(cols < n, row[np.minimum(cols, n - 1)], np.inf).astype(np.float32)
        todo = _before(c, cols, d[k - 1], j[k - 1])
        m = int(todo.sum())
        if m >= merge_at:
            # the survivors compacted to lanes [0, m), the rest empty,
            # sorted over the first 8, 16 or 32 lanes
            sd = np.full(32, np.inf, np.float32)
            sj = np.full(32, EMPTY)
            sd[:m], sj[:m] = c[todo], cols[todo]
            width = 8 if m <= 8 else 16 if m <= 16 else 32
            step = 2
            while step <= width:
                s = step >> 1
                while s:
                    sd, sj = _bitonic_step(sd, sj, s, (lane & step) == 0)
                    s >>= 1
                step <<= 1
            rd, rj = sd[31 - lane], sj[31 - lane]
            take = _before(rd, rj, d, j)
            d, j = np.where(take, rd, d), np.where(take, rj, j)
            for s in (16, 8, 4, 2, 1):
                d, j = _bitonic_step(d, j, s, np.ones(32, bool))
            continue
        while todo.any():
            src = int(np.argmax(todo))
            at = int(_before(d, j, c[src], cols[src]).sum())
            d = np.concatenate([d[:at], [c[src]], d[at:31]]).astype(np.float32)
            j = np.concatenate([j[:at], [cols[src]], j[at:31]])
            todo[src] = False
            todo &= _before(c, cols, d[k - 1], j[k - 1])
    return j[:k], d[:k]


def _rounds_row(row, k):
    """knn_rounds_kernel on one row: k rounds of argmin, first index on
    ties, the winner knocked out with +inf."""
    row = row.copy()
    js, ds = [], []
    for _ in range(k):
        w = int(np.argmin(row))  # the first index among equal minima
        js.append(w)
        ds.append(row[w])
        row[w] = np.inf
    return np.array(js), np.array(ds, np.float32)


def replay_knn(pos, mask, k, merge_at=MERGE_AT):
    """The kernel's (idx, mask) by its route for k."""
    d2 = _kernel_d2(pos, mask)
    B, n, _ = d2.shape
    idx, nmask = np.zeros((B, n, k), np.int64), np.zeros((B, n, k), bool)
    for b in range(B):
        for i in range(n):
            js, ds = (_warp_row(d2[b, i], i, k, merge_at) if k <= WARP_K
                      else _rounds_row(d2[b, i], k))
            idx[b, i], nmask[b, i] = js, ds < np.float32(0.5) * BIG32
    return idx, nmask


def _tie_heavy(n, seed, scale):
    """Positions on an integer grid (many equal d2; scale 1 keeps them exact,
    another scale lets rounding decide near-ties) and masks: one complex
    whole, one with scattered masked rows, one with 5 valid atoms, one
    padded whole."""
    rng = np.random.default_rng(seed)
    pos = (rng.integers(0, 4, size=(4, n, 3)) * scale + (0.0 if scale == 1 else 10.0))
    mask = np.ones((4, n), bool)
    mask[1, rng.random(n) < 0.3] = False
    mask[2, 5:] = False
    mask[3] = False
    return pos.astype(np.float32), mask


@pytest.mark.parametrize("k,n", [(1, 20), (8, 20), (1, 45), (8, 45), (32, 45), (1, 97), (8, 97),
                                 (32, 97), (48, 97)])
def test_knn_replay_equals_exact_on_ties(k, n):
    """The kernel's selection, replayed (both routes: the warp list for
    k <= 32, the row's own batch first, batches merged from MERGE_AT
    survivors, from the first one, or never; K argmin rounds for k = 48), bitwise equal to
    knn_graph_exact on tie-heavy grids with masked rows, rows with fewer
    valid neighbours than k and an all-masked complex; padded rows get
    0..k-1, masked."""
    for scale in (1.0, 0.37):
        pos, mask = _tie_heavy(n, k * 1000 + n, scale)
        want = G.knn_graph_exact(torch.from_numpy(pos), torch.from_numpy(mask), k)
        for merge_at in ((1, MERGE_AT, 33) if k <= WARP_K else (None,)):
            idx, nmask = replay_knn(pos, mask, k, merge_at)
            np.testing.assert_array_equal(idx, want.idx.numpy())
            np.testing.assert_array_equal(nmask, want.mask.numpy())
        assert (idx[3] == np.arange(k)).all() and not nmask[3].any()
        assert (nmask[2, :5].sum(-1) == min(4, k)).all()
