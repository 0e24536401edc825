"""The port's kNN graph (plain version of the CUDA kernel csrc/knn.cu)
against the JAX package's Pallas kNN kernel in interpret mode and its XLA
knn_graph, on tie-free geometry with masked rows."""

import jax.numpy as jnp
import numpy as np
import torch

from targetdiff_tpu.ops import graph as JG
from targetdiff_tpu.ops.pallas.knn import knn_graph_pallas
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
