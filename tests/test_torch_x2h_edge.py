"""The x2h edge kernel's algorithm (targetdiff_tpu_torch/csrc/x2h_edge.cuh)
replayed in plain PyTorch on the CPU: a row's edges in 32-slot chunks,
chunks without a valid edge skipped, one walk with an online per-head
softmax (running max and denominator, rescaled value sums), and both second
layers as three-term fp16 products (lo*hi + hi*lo + hi*hi of the weights
times 2^8 and the activations, operands rounded to fp16 by bit masks, to
nearest even as `__float2half_rn` rounds, each product exact in float32).
The replay is held
against the port's plain x2h layer and against the JAX per-layer kernel in
interpret mode at float32, at the released widths (hidden 128, 16 heads) on
kNN graphs of K = 8 and 32 and a hybrid graph of K = 95 (a dead chunk on
every protein row, K not a multiple of 32), with rows that have no valid
edge. Weights are random from a torch seed, carried to JAX by utils/port.py;
inputs come from numpy seeds."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from targetdiff_tpu.models.fast_forward import extract_layer_params
from targetdiff_tpu.ops.pallas.edge_layer import x2h_attention_layer as jax_x2h
from targetdiff_tpu.ops.rbf import gaussian_smearing_offsets as jax_offsets
from targetdiff_tpu_torch.data.batch import from_numpy
from targetdiff_tpu_torch.models.score_model import DiffusionModel
from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels import edge_layer
from targetdiff_tpu_torch.ops.rbf import gaussian_smearing, gaussian_smearing_offsets
from targetdiff_tpu_torch.utils.port import state_dict_to_flax_params
from tests.test_fast_forward import NUM_CLASSES, PROTEIN_DIM, small_flagship

torch.set_num_threads(2)

H_TOL = dict(atol=2e-3, rtol=1e-2)  # tests/test_torch_edge_layer.py (features)
X2H_ATOL = 1e-5  # the float32-grade bar the kernel is held to on the card (chip_smoke.py)
KC = 32  # slots per chunk (csrc/block_common.cuh)


W_SCALE = 256.0  # the kernel stages the second layers times 2^8 (csrc kWScale)


def f16(a):
    """a rounded to fp16 in float32, to nearest with ties to even: in fp16's
    normal range (|a| >= 2^-14) by adding 0xfff plus the kept part's lowest
    bit and clearing the 13 dropped mantissa bits, below it on fp16's
    subnormal grid of 2^-24 (torch.round ties to even)."""
    bits = a.contiguous().view(torch.int32)
    normal = ((bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000).view(torch.float32)
    return torch.where(a.abs() >= 2.0 ** -14, normal, torch.round(a * 2.0 ** 24) / 2.0 ** 24)


def split3_matmul(a, w):
    """a @ w as the kernel's tensor cores compute it: w times 2^8, both split
    into fp16 hi and the rounded remainder lo, lo*hi + hi*lo + hi*hi (each
    product exact in float32), float32 sums, scaled back."""
    w = w * W_SCALE
    a_hi, w_hi = f16(a), f16(w)
    a_lo, w_lo = f16(a - a_hi), f16(w - w_hi)
    return (a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi) / W_SCALE


def x2h_replay(h, x, nbh, mask_ligand, e_w, params, matmul=split3_matmul):
    """h' [B,N,H] of the x2h pass as the kernel computes it, from one layer's
    packed weights (`pack_layer_params`): node projections, then per row its
    live chunks in one walk with an online softmax, the second layers through
    `matmul`."""
    p = {k: v[0] for k, v in params.items()}
    B, N, H = h.shape
    K = nbh.idx.shape[-1]
    dh = 8  # head width at the released widths (csrc DH)
    heads = H // dh
    proj = h @ p["w_node"] + p["b_node"]  # [k.h_i | v.h_i | k.h_j | v.h_j | q1]
    ni, nj = proj[..., :2 * H], proj[..., 2 * H:4 * H]
    q = F.relu(F.layer_norm(proj[..., 4 * H:], (H,), p["q_ln"][0], p["q_ln"][1], 1e-5))
    q = q @ p["w_q2"] + p["b_q2"]
    etype = G.edge_types(nbh, mask_ligand).argmax(-1)
    offsets, coeff = gaussian_smearing_offsets()
    rbf = gaussian_smearing(G.rel_geometry(x, nbh)[1], offsets, coeff)  # [B,N,K,R]
    out = h.clone()
    walked = {"rows": 0, "chunks": 0, "dead_chunks": 0, "empty_rows": 0}
    for b in range(B):
        for i in range(N):
            valid = nbh.mask[b, i]
            if not bool(valid.any()):  # no valid edge: h unchanged
                walked["empty_rows"] += 1
                continue
            walked["rows"] += 1
            m = torch.full((heads,), -math.inf)
            den, acc = torch.zeros(heads), torch.zeros(H)
            for e0 in range(0, K, KC):
                sl = slice(e0, min(e0 + KC, K))
                v = valid[sl]
                if not bool(v.any()):  # dead chunk: zero weight, skipped
                    walked["dead_chunks"] += 1
                    continue
                walked["chunks"] += 1
                j, t = nbh.idx[b, i, sl][v], etype[b, i, sl][v]
                z = (ni[b, i] + nj[b, j] + p["w_et"][t]
                     + torch.einsum("er,erc->ec", rbf[b, i, sl][v], p["w_rbf"][t]))
                zk, zv = (F.relu(F.layer_norm(z[:, s], (H,), p["kv_ln"][0, s], p["kv_ln"][1, s],
                                              1e-5))
                          for s in (slice(0, H), slice(H, 2 * H)))
                k = matmul(zk, p["w2k"]) + p["b2k"]
                val = matmul(zv, p["w2v"]) + p["b2v"]
                logit = (k * q[b, i]).reshape(-1, heads, dh).sum(-1) / math.sqrt(dh)
                m_new = torch.maximum(m, logit.max(0).values)
                pexp = torch.exp(logit - m_new)
                scale = torch.exp(m - m_new)
                den = den * scale + pexp.sum(0)
                weighted = (pexp * e_w[b, i, sl][v][:, None]).repeat_interleave(dh, 1) * val
                acc = acc * scale.repeat_interleave(dh) + weighted.sum(0)
                m = m_new
            out[b, i] = h[b, i] + acc / den.clamp_min(1e-16).repeat_interleave(dh)
    return out, walked


CASES = {  # cutoff_mode, k, protein slots, ligand slots: N = protein + ligand, K
    "knn_K8": ("knn", 8, 40, 8),
    "knn_K32": ("knn", 32, 40, 8),
    "hybrid_K95": ("hybrid", 32, 40, 64),
}


def _case(cutoff_mode, k, n_protein, n_ligand, seed=0):
    """A one-layer model at the released widths (torch seed), one layer's
    inputs (numpy seed): two complexes, the first with three padded protein
    rows, the second with a third of its ligand slots used and (kNN) fewer
    valid atoms than K + 1."""
    cfg = small_flagship()
    cfg.update(hidden_dim=128, n_heads=16, num_layers=1, knn=k, cutoff_mode=cutoff_mode)
    torch.manual_seed(seed)
    model = DiffusionModel(cfg, PROTEIN_DIM, NUM_CLASSES, device="cpu", max_protein=n_protein,
                           max_ligand=n_ligand)
    rng = np.random.default_rng(seed)
    B = 2
    pmask = np.ones((B, n_protein), bool)
    pmask[0, n_protein - 3:] = False
    if cutoff_mode == "knn":
        pmask[1, 20:] = False  # fewer valid atoms than K + 1 at K = 32: partial chunks
    lmask = np.arange(n_ligand)[None] < np.array([[n_ligand], [n_ligand // 3]])
    batch = from_numpy(rng.normal(size=(B, n_protein, 3)) * 3,
                       rng.random((B, n_protein, PROTEIN_DIM)) > 0.7, pmask,
                       rng.normal(size=(B, n_ligand, 3)) * 1.5,
                       rng.integers(0, NUM_CLASSES, (B, n_ligand)), lmask)
    rn = model.net.refine_net
    with torch.no_grad():
        _, x, node_mask, mlig = model.net.embed(*batch)
        nbh = rn.graph(x, node_mask, mlig)
    h = torch.from_numpy(rng.normal(size=(B, x.shape[1], 128)).astype(np.float32))
    e_w = torch.from_numpy(rng.uniform(0.1, 1.0, size=nbh.idx.shape).astype(np.float32))
    return model, h, x, nbh, mlig, e_w


@pytest.mark.parametrize("case", list(CASES))
def test_x2h_edge_replay_matches_plain_and_jax(case):
    cutoff_mode, k, n_protein, n_ligand = CASES[case]
    model, h, x, nbh, mlig, e_w = _case(cutoff_mode, k, n_protein, n_ligand)
    K = nbh.idx.shape[-1]
    assert K == (k if cutoff_mode == "knn" else n_ligand - 1 + k)
    layer = model.net.refine_net.base_block[0]
    with torch.no_grad():
        px, _ = edge_layer.pack_layer_params(layer)
        got, walked = x2h_replay(h, x, nbh, mlig, e_w, px)
        plain = edge_layer.x2h_layer_plain(layer, h, x, nbh, mlig, e_w)
    # the walk met what the case is for: empty rows, and for K > 32 dead
    # chunks and a partial last chunk
    assert walked["empty_rows"] > 0
    assert (walked["dead_chunks"] > 0) == (K > KC)
    empty = ~nbh.mask.any(-1)
    assert torch.equal(got[empty], h[empty])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **H_TOL)
    # three-term fp16 products keep the float32 result: inside the card's
    # float32-grade bar, which one fp16 product per term misses
    assert float((got - plain).abs().max()) < X2H_ATOL

    # the JAX per-layer kernel in interpret mode, float32, same weights
    block = state_dict_to_flax_params(model.net.state_dict())["params"]["refine_net"]["block_0"]
    jpx, _ = extract_layer_params(block, 128, 20)
    offsets, coeff = jax_offsets(0.0, 10.0, 20)
    etype = G.edge_types(nbh, mlig).argmax(-1).int().numpy()
    want = jax_x2h(jnp.asarray(h.numpy()), jnp.asarray(x.numpy()),
                   jnp.asarray(nbh.idx.int().numpy()), jnp.asarray(nbh.mask.numpy()),
                   jnp.asarray(etype), jnp.asarray(e_w.numpy()), offsets, jpx, n_heads=16,
                   coeff=coeff, dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **H_TOL)


def test_f16_rounding_and_three_term_product():
    """f16 rounds as torch's float16 conversion does, normal and subnormal;
    the three-term product sits as close to float64 as a float32 product,
    where one fp16 product sits ~1e-3 away."""
    ties = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11), 3.0])
    assert f16(ties).tolist() == [1.0, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -9), 3.0]
    rng = np.random.default_rng(0)
    spread = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.uniform(-9, 3, 4096))
                              .astype(np.float32))
    assert torch.equal(f16(spread), spread.half().float())
    a = torch.from_numpy(np.abs(rng.normal(size=(64, 128))).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(128, 128)).astype(np.float32)) / math.sqrt(128)
    exact = a.double() @ w.double()
    scale = float(exact.abs().max())
    three = float((split3_matmul(a, w).double() - exact).abs().max()) / scale
    fp32 = float(((a @ w).double() - exact).abs().max()) / scale
    single = float((f16(a) @ f16(w) - exact).double().abs().max()) / scale
    assert three < 2 * fp32 + 1e-7 and single > 1e-4


@pytest.mark.parametrize("product", ["fp16", "bf16"])
def test_one_term_product_misses_the_float32_grade_bar(product):
    """The card's float32-grade bar tells the kernel's three-term products
    from a single low-precision product per term: the replay with one fp16
    (weights times 2^8) or one bf16 product misses it."""
    if product == "fp16":
        def single(a, w):
            return f16(a) @ f16(w * W_SCALE) / W_SCALE
    else:
        def single(a, w):
            return a.bfloat16().float() @ w.bfloat16().float()
    model, h, x, nbh, mlig, e_w = _case(*CASES["knn_K32"])
    layer = model.net.refine_net.base_block[0]
    with torch.no_grad():
        px, _ = edge_layer.pack_layer_params(layer)
        plain = edge_layer.x2h_layer_plain(layer, h, x, nbh, mlig, e_w)
        got, _ = x2h_replay(h, x, nbh, mlig, e_w, px, matmul=single)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **H_TOL)  # the loose bar holds
    assert float((got - plain).abs().max()) > 10 * X2H_ATOL
