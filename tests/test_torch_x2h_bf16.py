"""The bf16 x2h edge kernel's algorithm (targetdiff_tpu_torch/csrc/
x2h_edge_bf16.cuh) replayed in plain PyTorch on the CPU at the released
widths (hidden 128, 16 heads, 20 RBF knots): rows dealt round-robin to
consumers, each consumer's live 32-slot chunks taken two at a time as
64-slot tiles, the first layer as one product of the tile's rows [one-hot
edge type | type x RBF | 0] with the stacked table [w_et; w_rbf]
(`pack_first_layer_table`; bf16 operands, float32 sums) plus ni + nj,
LayerNorm + ReLU on the first-layer sums, the second layer on their bf16
rounding, softmax partials per 16-slot warp merged in slot order into an
online softmax across a row's tiles. The replay is held against the port's
bf16 plain x2h layer and the JAX per-layer kernel (`x2h_attention_layer(...,
dtype=jnp.bfloat16, interpret=True)`) at the JAX package's bf16 bar, on kNN
graphs of K = 8 and 32 and hybrid graphs of K = 40 and 95, whose walks meet
rows without a valid edge, dead chunks, partial last chunks and tiles that
straddle a protein row and a ligand row. A second check: the stacked table
is the Linear's edge-feature columns, and a slot's row times it equals the
per-type sum w_et[t] + sum_r rbf_r w_rbf[t][r] bitwise (the one-hot
products are exact)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from targetdiff_tpu.models.fast_forward import extract_layer_params
from targetdiff_tpu.ops.pallas.edge_layer import x2h_attention_layer as jax_x2h
from targetdiff_tpu.ops.rbf import gaussian_smearing_offsets as jax_offsets
from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels import block_denoiser as kblock
from targetdiff_tpu_torch.ops.kernels import edge_layer
from targetdiff_tpu_torch.ops.precision import round_bf16
from targetdiff_tpu_torch.ops.rbf import gaussian_smearing, gaussian_smearing_offsets
from targetdiff_tpu_torch.utils.port import state_dict_to_flax_params
from tests.test_torch_x2h_edge import _case

torch.set_num_threads(2)

BAR = 2e-2  # the JAX package's bf16 bar: max |a - b| / max |b| (tools/kparity.py:91)
KC, TILE, WARP = 32, 64, 16  # slots per chunk, per tile, per warp partial (csrc)
HEADS, DH = 16, 8


def rel(a, b, rows) -> float:
    """max |a - b| / max |b| over the rows."""
    a, b = a[rows].double(), b[rows].double()
    return float((a - b).abs().max() / b.abs().max())


def first_layer_rows(etype, rbf, valid):
    """Slots' first-layer A rows [E, FIRST_LAYER_DEPTH]: one-hot type |
    type x RBF (the type's R-column block) | 0; zero where invalid."""
    E, R = rbf.shape
    rows = torch.zeros(E, kblock.FIRST_LAYER_DEPTH)
    onehot = F.one_hot(etype, 4).float()
    rows[:, :4] = onehot
    rows[:, 4:4 + 4 * R] = (onehot[:, :, None] * rbf[:, None, :]).reshape(E, 4 * R)
    return rows * valid[:, None]


def x2h_bf16_replay(h, x, nbh, mask_ligand, e_w, params, consumers=4):
    """h' [B,N,H] of the bf16 x2h pass as the kernel computes it from one
    layer's bf16 stacks (`pack_layer_params(..., torch.bfloat16)`), with its
    walk's record."""
    p = {k: v[0].float() for k, v in params.items()}
    B, N, H = h.shape
    K = nbh.idx.shape[-1]
    rows = B * N
    ni, nj, q, _ = kblock.node_projections_plain(h.reshape(-1, H), params)
    table = kblock.pack_first_layer_table(params).float()
    etype = G.edge_types(nbh, mask_ligand).argmax(-1).reshape(rows, K)
    offsets, coeff = gaussian_smearing_offsets()
    rbf = round_bf16(gaussian_smearing(G.rel_geometry(x, nbh)[1], offsets, coeff))
    rbf = rbf.reshape(rows, K, -1)
    valid, ew = nbh.mask.reshape(rows, K), e_w.reshape(rows, K)
    src = (torch.arange(rows) // N * N)[:, None] + nbh.idx.reshape(rows, K)
    lig = mask_ligand.reshape(rows)
    out = h.reshape(rows, H).clone()
    walked = {"empty_rows": 0, "dead_chunks": 0, "partial_last_chunks": 0, "tiles": 0,
              "straddling_tiles": 0, "two_chunk_rows_in_a_tile": 0}
    n_chunks = -(-K // KC)
    for u in range(consumers):
        stream = []  # the consumer's live chunks in order: (row, chunk, first, last)
        for r in range(u, rows, consumers):
            live = [c for c in range(n_chunks) if bool(valid[r, KC * c:KC * (c + 1)].any())]
            if not live:  # no valid edge: h unchanged
                walked["empty_rows"] += 1
                continue
            walked["dead_chunks"] += n_chunks - len(live)
            walked["partial_last_chunks"] += int(K % KC != 0 and live[-1] == n_chunks - 1)
            stream += [(r, c, i == 0, i == len(live) - 1) for i, c in enumerate(live)]
        m_run = d_run = o_run = None
        for t0 in range(0, len(stream), 2):
            tile = stream[t0:t0 + 2]
            walked["tiles"] += 1
            if len(tile) == 2:
                (ra, *_), (rb, *_) = tile
                walked["straddling_tiles"] += int(bool(lig[ra]) != bool(lig[rb]))
                walked["two_chunk_rows_in_a_tile"] += int(ra == rb)
            # the producer's slots: A rows, sources, e_w, validity, the chunk's row
            a_rows = torch.zeros(TILE, kblock.FIRST_LAYER_DEPTH)
            ni_t, nj_t, q_t = torch.zeros(TILE, 2 * H), torch.zeros(TILE, 2 * H), torch.zeros(TILE, H)
            ew_t, v_t = torch.zeros(TILE), torch.zeros(TILE, dtype=torch.bool)
            for pos, (r, c, _, _) in enumerate(tile):
                sl = slice(KC * c, min(KC * (c + 1), K))
                n = sl.stop - sl.start
                m = slice(KC * pos, KC * pos + n)
                v = valid[r, sl]
                a_rows[m] = first_layer_rows(etype[r, sl], rbf[r, sl], v)
                nj_t[m] = torch.where(v[:, None], nj[src[r, sl]], 0.0)
                ni_t[KC * pos:KC * (pos + 1)] = ni[r]
                q_t[KC * pos:KC * (pos + 1)] = q[r]
                ew_t[m] = torch.where(v, ew[r, sl], 0.0)
                v_t[m] = v
            halves = []
            for kv in range(2):
                s = slice(kv * H, (kv + 1) * H)
                z = a_rows @ table[:, s] + (ni_t[:, s] + nj_t[:, s])
                z = F.relu(F.layer_norm(z, (H,), p["kv_ln"][0, s], p["kv_ln"][1, s], 1e-5))
                w2, b2 = (p["w2v"], p["b2v"]) if kv else (p["w2k"], p["b2k"])
                halves.append(round_bf16(z) @ w2 + b2)
            k, val = halves
            logit = (k * q_t).reshape(TILE, HEADS, DH).sum(-1) / math.sqrt(DH)
            logit = torch.where(v_t[:, None], logit, -math.inf)
            parts = []  # per 16-slot warp: max, exp-sum, e_w-weighted value sum
            for w in range(TILE // WARP):
                ws = slice(WARP * w, WARP * (w + 1))
                mx = logit[ws].max(0).values
                if not bool(v_t[ws].any()):
                    parts.append(None)  # no valid slot: the merge skips it
                    continue
                pexp = torch.exp(logit[ws] - mx)
                pw = (pexp * ew_t[ws, None]).repeat_interleave(DH, 1)
                parts.append((mx, pexp.sum(0), (pw * val[ws]).sum(0)))
            for pos, (r, _, first, last) in enumerate(tile):
                if first:
                    m_run, d_run, o_run = torch.full((HEADS,), -math.inf), torch.zeros(HEADS), \
                        torch.zeros(H)
                for part in parts[2 * pos:2 * pos + 2]:
                    if part is None:
                        continue
                    mw, sw, vw = part
                    mn = torch.maximum(m_run, mw)
                    a, b = torch.exp(m_run - mn), torch.exp(mw - mn)
                    d_run = d_run * a + sw * b
                    o_run = o_run * a.repeat_interleave(DH) + vw * b.repeat_interleave(DH)
                    m_run = mn
                if last:
                    out[r] = out[r] + o_run / d_run.clamp_min(1e-16).repeat_interleave(DH)
    return out.reshape(B, N, H), walked


CASES = {  # cutoff_mode, k, protein slots, ligand slots: N = protein + ligand, K
    "knn_K8": ("knn", 8, 40, 8),
    "knn_K32": ("knn", 32, 40, 8),
    "hybrid_K40": ("hybrid", 32, 39, 9),
    "hybrid_K95": ("hybrid", 32, 40, 64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_x2h_bf16_replay_matches_plain_and_jax(case):
    cutoff_mode, k, n_protein, n_ligand = CASES[case]
    model, h, x, nbh, mlig, e_w = _case(cutoff_mode, k, n_protein, n_ligand)
    K = nbh.idx.shape[-1]
    assert K == (k if cutoff_mode == "knn" else n_ligand - 1 + k)
    layer = model.net.refine_net.base_block[0]
    with torch.no_grad():
        px, _ = edge_layer.pack_layer_params(layer, torch.bfloat16)
        got, walked = x2h_bf16_replay(h, x, nbh, mlig, e_w, px)
        plain = edge_layer.x2h_layer_plain(layer, h, x, nbh, mlig, e_w, torch.bfloat16)
        f32 = edge_layer.x2h_layer_plain(layer, h, x, nbh, mlig, e_w)
    # the walk met what the case is for
    assert walked["empty_rows"] > 0 and walked["straddling_tiles"] > 0
    if K > KC:
        assert walked["dead_chunks"] > 0 and walked["two_chunk_rows_in_a_tile"] > 0
    assert (walked["partial_last_chunks"] > 0) == (K % KC != 0)
    empty = ~nbh.mask.any(-1)
    assert torch.equal(got[empty], h[empty])
    rows = ~empty
    assert rel(got, plain, rows) < BAR
    assert rel(got, f32, rows) > 0  # bf16 rounding points, not the float32 layer

    # the JAX per-layer kernel in bf16, interpret mode, same weights
    block = state_dict_to_flax_params(model.net.state_dict())["params"]["refine_net"]["block_0"]
    jpx, _ = extract_layer_params(block, 128, 20)
    offsets, coeff = jax_offsets(0.0, 10.0, 20)
    etype = G.edge_types(nbh, mlig).argmax(-1).int().numpy()
    want = jax_x2h(jnp.asarray(h.numpy()), jnp.asarray(x.numpy()),
                   jnp.asarray(nbh.idx.int().numpy()), jnp.asarray(nbh.mask.numpy()),
                   jnp.asarray(etype), jnp.asarray(e_w.numpy()), offsets, jpx, n_heads=16,
                   coeff=coeff, dtype=jnp.bfloat16, interpret=True)
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    assert rel(got, want, rows) < BAR
    assert rel(plain, want, rows) < BAR


def test_first_layer_table_is_the_per_type_sum():
    """The stacked table holds the Linear's edge-feature columns, and a
    slot's row times it, summed in table order, equals w_et[t] + sum_r
    rbf_r w_rbf[t][r] in the same order bitwise, for every type."""
    model, h, x, nbh, mlig, e_w = _case(*CASES["hybrid_K40"])
    layer = model.net.refine_net.base_block[0]
    with torch.no_grad():
        px, _ = edge_layer.pack_layer_params(layer, torch.bfloat16)
        table = kblock.pack_first_layer_table(px).float()
        att = layer.x2h_layers[0]
        w1 = torch.cat([att.hk_func.net[0].weight, att.hv_func.net[0].weight])  # [2H, in]
    n_feat = 4 + 4 * 20
    assert table.shape == (kblock.FIRST_LAYER_DEPTH, 256)
    assert torch.equal(table[:n_feat], round_bf16(w1[:, :n_feat].t()))
    assert not bool(table[n_feat:].any())
    etype = G.edge_types(nbh, mlig).argmax(-1)[nbh.mask]
    offsets, coeff = gaussian_smearing_offsets()
    rbf = round_bf16(gaussian_smearing(G.rel_geometry(x, nbh)[1], offsets, coeff))[nbh.mask]
    assert set(etype.tolist()) == {0, 1, 2, 3}
    a = first_layer_rows(etype, rbf, torch.ones(len(etype)))
    got = torch.zeros(len(etype), 256)
    for kk in range(kblock.FIRST_LAYER_DEPTH):  # the table's order
        got = got + a[:, kk, None] * table[kk]
    p = {k: v[0].float() for k, v in px.items()}
    want = p["w_et"][etype].clone()
    for r in range(20):
        want = want + rbf[:, r, None] * p["w_rbf"][etype, r]
    assert torch.equal(got, want)
