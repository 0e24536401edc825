"""The h2x edge kernel's and the node kernel's algorithms
(targetdiff_tpu_torch/csrc/h2x_edge.cuh, node_proj.cuh) replayed in plain
PyTorch on the CPU.

h2x: work units of (ligand row, live 32-slot chunk), chunks without a valid
edge skipped, each unit's per-head partials (the chunk's max logit m,
d = sum exp(l - m), S = sum exp(l - m) e_w v rel) merged per row in chunk
order, both second layers as three-term fp16 products. Held against the
port's plain h2x layer and the JAX per-layer kernel in interpret mode at
float32, at the released widths (hidden 128, 16 heads) on kNN graphs of
K = 8 and 32 and a hybrid graph of K = 95 (a dead chunk on every protein
row, K not a multiple of 32), with ligand rows that have no valid edge.

Node projections: each row of h scaled by the power of two that brings its
largest |h| into [2^14, 2^15), three-term fp16 products, scaled back; held
against float64 on rows of largest |h| near 1e5 and 1e-5, where one fp16
product, or the split without the scaling, misses the float32-grade bar.
Weights are random from a torch seed, carried to JAX by utils/port.py;
inputs come from numpy seeds."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from targetdiff_tpu.models.fast_forward import extract_layer_params
from targetdiff_tpu.ops.pallas.edge_layer import h2x_attention_layer as jax_h2x
from targetdiff_tpu.ops.rbf import gaussian_smearing_offsets as jax_offsets
from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
from targetdiff_tpu_torch.ops.kernels import edge_layer
from targetdiff_tpu_torch.ops.rbf import gaussian_smearing, gaussian_smearing_offsets
from targetdiff_tpu_torch.utils.port import state_dict_to_flax_params
from tests.test_torch_x2h_edge import CASES, KC, W_SCALE, _case

torch.set_num_threads(2)

POS_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_torch_edge_layer.py (positions)
H2X_ATOL = 1e-5  # the float32-grade bar the kernel is held to on the card (chip_smoke.py)


def half(a):
    """a rounded to fp16 with fp16's range: inf above 65504, its subnormals
    below 2^-14 (as `__float2half_rn`)."""
    return a.half().float()


def split3_half(a, w):
    """a @ w as the kernels' tensor cores compute it: w times 2^8, both split
    into fp16 hi and the rounded remainder lo, lo*hi + hi*lo + hi*hi (each
    product exact in float32), float32 sums, scaled back."""
    w = w * W_SCALE
    a_hi, w_hi = half(a), half(w)
    a_lo, w_lo = half(a - a_hi), half(w - w_hi)
    return (a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi) / W_SCALE


def h2x_replay(h, x, nbh, mask_ligand, e_w, params, n_ligand, matmul=split3_half):
    """x' [B,N,3] of the h2x pass as the kernel computes it, from one layer's
    packed weights (`pack_layer_params`): node projections, then per ligand
    row one unit per live chunk, each unit's per-head partials, merged in
    chunk order; the second layers through `matmul`."""
    p = {k: v[0] for k, v in params.items()}
    B, N, H = h.shape
    K = nbh.idx.shape[-1]
    dh = 8  # head width at the released widths (csrc DH)
    heads = H // dh
    ni, nj, q, _ = kblock.node_projections_plain(h, params)
    etype = G.edge_types(nbh, mask_ligand).argmax(-1)
    offsets, coeff = gaussian_smearing_offsets()
    rel_x, dist = G.rel_geometry(x, nbh)
    rbf = gaussian_smearing(dist, offsets, coeff)  # [B,N,K,R]
    out = x.clone()
    walked = {"rows": 0, "units": 0, "dead_chunks": 0, "empty_rows": 0}  # dead: on live rows
    for b in range(B):
        for i in range(N - n_ligand, N):
            valid = nbh.mask[b, i]
            units, dead = [], 0
            for e0 in range(0, K, KC):
                sl = slice(e0, min(e0 + KC, K))
                v = valid[sl]
                if not bool(v.any()):  # dead chunk: zero weight, skipped
                    dead += 1
                    continue
                j, t = nbh.idx[b, i, sl][v], etype[b, i, sl][v]
                z = (ni[b, i] + nj[b, j] + p["w_et"][t]
                     + torch.einsum("er,erc->ec", rbf[b, i, sl][v], p["w_rbf"][t]))
                zk, zv = (F.relu(F.layer_norm(z[:, s], (H,), p["kv_ln"][0, s], p["kv_ln"][1, s],
                                              1e-5))
                          for s in (slice(0, H), slice(H, 2 * H)))
                k = matmul(zk, p["w2k"]) + p["b2k"]
                val = matmul(zv, p["w2v"]) + p["b2v"]  # [n, heads]
                logit = (k * q[b, i]).reshape(-1, heads, dh).sum(-1) / math.sqrt(dh)
                m = logit.max(0).values
                pexp = torch.exp(logit - m)
                s = torch.einsum("eh,ec->hc", pexp * e_w[b, i, sl][v][:, None] * val,
                                 rel_x[b, i, sl][v])
                units.append((m, pexp.sum(0), s))
            if not units:  # no valid edge: x unchanged
                walked["empty_rows"] += 1
                continue
            walked["rows"] += 1
            walked["units"] += len(units)
            walked["dead_chunks"] += dead
            m_row = torch.stack([u[0] for u in units]).max(0).values
            den, s_row = torch.zeros(heads), torch.zeros(heads, 3)
            for m, d, s in units:  # chunk order
                f = torch.exp(m - m_row)
                den = den + d * f
                s_row = s_row + s * f[:, None]
            delta = (s_row / den.clamp_min(1e-16)[:, None]).sum(0) / heads
            out[b, i] = x[b, i] + mask_ligand[b, i].float() * delta
    return out, walked


def _jax_h2x(model, h, x, nbh, mlig, e_w, n_ligand):
    block = state_dict_to_flax_params(model.net.state_dict())["params"]["refine_net"]["block_0"]
    _, jph = extract_layer_params(block, 128, 20)
    offsets, coeff = jax_offsets(0.0, 10.0, 20)
    etype = G.edge_types(nbh, mlig).argmax(-1).int().numpy()
    return np.asarray(jax_h2x(
        jnp.asarray(h.numpy()), jnp.asarray(x.numpy()), jnp.asarray(nbh.idx.int().numpy()),
        jnp.asarray(nbh.mask.numpy()), jnp.asarray(etype), jnp.asarray(e_w.numpy()),
        jnp.asarray(mlig.numpy()), offsets, jph, n_heads=16, coeff=coeff, dtype=jnp.float32,
        interpret=True, n_ligand=n_ligand))


@pytest.mark.parametrize("case", list(CASES))
def test_h2x_edge_replay_matches_plain_and_jax(case):
    cutoff_mode, k, n_protein, n_ligand = CASES[case]
    model, h, x, nbh, mlig, e_w = _case(cutoff_mode, k, n_protein, n_ligand)
    K = nbh.idx.shape[-1]
    assert K == (k if cutoff_mode == "knn" else n_ligand - 1 + k)
    layer = model.net.refine_net.base_block[0]
    with torch.no_grad():
        _, ph = edge_layer.pack_layer_params(layer)
        got, walked = h2x_replay(h, x, nbh, mlig, e_w, ph, n_ligand)
        plain = edge_layer.h2x_layer_plain(layer, h, x, nbh, mlig, e_w)
    # the walk met what the case is for: ligand rows without a valid edge,
    # for K > 32 rows of several units and dead chunks
    assert walked["empty_rows"] > 0 and walked["rows"] > 0
    assert (walked["units"] > walked["rows"]) == (K > KC)
    assert (walked["dead_chunks"] > 0) == (K > KC)
    assert torch.equal(got[:, :-n_ligand], x[:, :-n_ligand])  # protein rows never move
    empty = ~nbh.mask.any(-1)
    assert torch.equal(got[empty], x[empty])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **POS_TOL)
    # three-term fp16 products keep the float32 result: inside the card's
    # float32-grade bar, which one fp16 product per term misses
    assert float((got - plain).abs().max()) < H2X_ATOL
    np.testing.assert_allclose(got.numpy(), _jax_h2x(model, h, x, nbh, mlig, e_w, n_ligand),
                               **POS_TOL)


def test_h2x_one_term_product_misses_the_float32_grade_bar():
    """The card's float32-grade bar tells the kernel's three-term products
    from one fp16 product per term (weights times 2^8)."""
    model, h, x, nbh, mlig, e_w = _case(*CASES["hybrid_K95"])
    layer = model.net.refine_net.base_block[0]
    with torch.no_grad():
        _, ph = edge_layer.pack_layer_params(layer)
        plain = edge_layer.h2x_layer_plain(layer, h, x, nbh, mlig, e_w)
        got, _ = h2x_replay(h, x, nbh, mlig, e_w, ph, CASES["hybrid_K95"][3],
                            matmul=PRODUCTS["one_fp16"])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **POS_TOL)  # the loose bar holds
    assert float((got - plain).abs().max()) > 3 * H2X_ATOL


def scaled_split3_matmul(h, w):
    """h @ w as the node kernel computes it: each row of h times the power of
    two 2^e that brings its largest |h| into [2^14, 2^15) (e = 0 for a row of
    zeros), three-term fp16 products, scaled back."""
    mx = h.abs().amax(-1, keepdim=True)
    e = torch.where(mx > 0, 15 - torch.frexp(mx).exponent, 0).clamp(-100, 100)
    f = torch.ldexp(torch.ones_like(mx), e)
    return split3_half(h * f, w) / f


PRODUCTS = {
    "scaled_split3": scaled_split3_matmul,
    "unscaled_split3": split3_half,
    "one_fp16": lambda a, w: half(a) @ half(w * W_SCALE) / W_SCALE,
}
NODE_REL = 4e-6  # float32-grade: largest error over the largest |exact| entry, per slice


def _node_rows(magnitude, seed=0):
    """16 rows of h whose largest |h| is near `magnitude` (a spread of 1e-3
    below it within each row), and a one-layer model's packed h2x weights."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(16, 128)) * 10.0 ** rng.uniform(-3, 0, size=(16, 128))
    h = h / np.abs(h).max(-1, keepdims=True) * magnitude * rng.uniform(0.6, 1.0, (16, 1))
    model, *_ = _case(*CASES["knn_K8"])
    _, ph = edge_layer.pack_layer_params(model.net.refine_net.base_block[0])
    return torch.from_numpy(h.astype(np.float32)), {k: v.detach() for k, v in ph.items()}


def node_replay(h, stacks, matmul):
    """(ni, nj, q) of the node kernel: the projections through `matmul`,
    LayerNorm + ReLU, the w_q2 product as three-term fp16 (a LayerNorm
    output: no scaling)."""
    p = {k: v[0] for k, v in stacks.items()}
    H = h.shape[-1]
    proj = matmul(h, p["w_node"]) + p["b_node"]
    qn = F.relu(F.layer_norm(proj[:, 4 * H:], (H,), p["q_ln"][0], p["q_ln"][1], 1e-5))
    return proj[:, :2 * H], proj[:, 2 * H:4 * H], split3_half(qn, p["w_q2"]) + p["b_q2"]


@pytest.mark.parametrize("magnitude", [1e5, 1e-5])
@pytest.mark.parametrize("product", list(PRODUCTS))
def test_node_products_scaled_rows_float32_grade(product, magnitude):
    """Rows of largest |h| near 1e5 (above fp16's range) and 1e-5 (in its
    subnormals): the kernel's scaled three-term products stay float32-grade
    against float64; without the row scaling, or with one fp16 product, the
    projections miss that bar."""
    h, stacks = _node_rows(magnitude)
    with torch.no_grad():
        got = node_replay(h, stacks, PRODUCTS[product])
        want = kblock.node_projections_plain(h.double(), {k: v.double() for k, v in
                                                          stacks.items()})[:3]
        fp32 = kblock.node_projections_plain(h, stacks)[:3]
    rel = [float((g.double() - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
    rel32 = [float((g.double() - w).abs().max() / w.abs().max()) for g, w in zip(fp32, want)]
    assert max(rel32) < NODE_REL  # the plain float32 projections meet the bar
    if product == "scaled_split3":
        assert max(rel) < NODE_REL, rel
    else:  # ni, nj carry h's scale: the miss (or the overflow) shows there
        assert not max(rel[:2]) < NODE_REL, rel


def test_node_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the node kernel's wrapper takes CUDA tensors only (the
    plain version is `node_projections_plain`)."""
    h, stacks = _node_rows(1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kblock.node_projections_cuda(h.reshape(2, 8, 128), stacks)
