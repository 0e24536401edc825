"""The bf16 h2x edge kernel's algorithm (targetdiff_tpu_torch/csrc/
h2x_edge_bf16.cuh) replayed in plain PyTorch on the CPU at the released
widths (hidden 128, 16 heads, 20 RBF knots): the rows [row0, N) of every
complex dealt round-robin to consumers, each consumer's live 32-slot chunks
taken two at a time as 64-slot tiles, the first layer as one product of the
tile's rows [one-hot edge type | type x RBF | 0] with the stacked table
[w_et; w_rbf] (`pack_first_layer_table`; bf16 operands, float32 sums) plus
ni + nj, LayerNorm + ReLU on the first-layer sums, the k second layer and the
16-wide v second layer on their bf16 rounding, per 16-slot warp each head's
max, exp-sum and sum of e_w exp(l - max) v rel, merged in slot order into an
online softmax across a row's tiles, x + mask (1/16) sum_h S_h / D_h at the
row's last chunk. The replay is held against the port's bf16 plain h2x layer
and the JAX per-layer kernel (`h2x_attention_layer(..., dtype=jnp.bfloat16,
interpret=True)`) at the JAX package's bf16 bar, on kNN graphs of K = 8 and
32 and hybrid graphs of K = 40 and 95, whose walks meet rows without a valid
edge (which keep x bitwise), padded ligand rows, partial last chunks, dead
chunks and tiles that straddle two rows."""

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
from targetdiff_tpu_torch.ops.precision import round_bf16
from targetdiff_tpu_torch.ops.rbf import gaussian_smearing, gaussian_smearing_offsets
from targetdiff_tpu_torch.utils.port import state_dict_to_flax_params
from tests.test_torch_x2h_bf16 import BAR, CASES, DH, HEADS, KC, TILE, WARP, first_layer_rows, rel
from tests.test_torch_x2h_edge import _case

torch.set_num_threads(2)


def h2x_bf16_replay(h, x, nbh, mask_ligand, e_w, params, n_ligand, consumers=4):
    """x' [B,N,3] of the bf16 h2x pass on the rows [N - n_ligand, N) as the
    kernel computes it from one layer's bf16 stacks (`pack_layer_params(...,
    torch.bfloat16)`), with its walk's record."""
    p = {k: v[0].float() for k, v in params.items()}
    B, N, H = h.shape
    K = nbh.idx.shape[-1]
    rows, row0 = B * N, N - n_ligand
    ni, nj, q, _ = kblock.node_projections_plain(h.reshape(-1, H), params)
    table = kblock.pack_first_layer_table(params).float()
    etype = G.edge_types(nbh, mask_ligand).argmax(-1).reshape(rows, K)
    offsets, coeff = gaussian_smearing_offsets()
    rel_x, dist = G.rel_geometry(x, nbh)
    rbf = round_bf16(gaussian_smearing(dist, offsets, coeff)).reshape(rows, K, -1)
    relr = rel_x.reshape(rows, K, 3)
    valid, ew = nbh.mask.reshape(rows, K), e_w.reshape(rows, K)
    src = (torch.arange(rows) // N * N)[:, None] + nbh.idx.reshape(rows, K)
    lig = mask_ligand.reshape(rows)
    xr = x.reshape(rows, 3)
    out = xr.clone()
    tail = [b * N + i for b in range(B) for i in range(row0, N)]  # row u of the pass: node tail[u]
    walked = {"empty_rows": 0, "padded_rows": 0, "dead_chunks": 0, "partial_last_chunks": 0,
              "tiles": 0, "two_row_tiles": 0, "two_chunk_rows_in_a_tile": 0}
    n_chunks = -(-K // KC)
    for u in range(consumers):
        stream = []  # the consumer's live chunks in order: (row, chunk, first, last)
        for r in tail[u::consumers]:
            walked["padded_rows"] += int(not bool(lig[r]))
            live = [c for c in range(n_chunks) if bool(valid[r, KC * c:KC * (c + 1)].any())]
            if not live:  # no valid edge: x unchanged
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
                same = tile[0][0] == tile[1][0]
                walked["two_chunk_rows_in_a_tile"] += int(same)
                walked["two_row_tiles"] += int(not same)
            # the producer's slots: A rows, sources, e_w, rel, validity, the chunk's row
            a_rows = torch.zeros(TILE, kblock.FIRST_LAYER_DEPTH)
            ni_t, nj_t, q_t = torch.zeros(TILE, 2 * H), torch.zeros(TILE, 2 * H), torch.zeros(TILE, H)
            ew_t, rel_t = torch.zeros(TILE), torch.zeros(TILE, 3)
            v_t = torch.zeros(TILE, dtype=torch.bool)
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
                rel_t[m] = torch.where(v[:, None], relr[r, sl], 0.0)
                v_t[m] = v
            halves = []
            for kv in range(2):
                s = slice(kv * H, (kv + 1) * H)
                z = a_rows @ table[:, s] + (ni_t[:, s] + nj_t[:, s])
                z = F.relu(F.layer_norm(z, (H,), p["kv_ln"][0, s], p["kv_ln"][1, s], 1e-5))
                w2, b2 = (p["w2v"], p["b2v"]) if kv else (p["w2k"], p["b2k"])
                halves.append(round_bf16(z) @ w2 + b2)
            k, val = halves  # [TILE, H], [TILE, HEADS]
            logit = (k * q_t).reshape(TILE, HEADS, DH).sum(-1) / math.sqrt(DH)
            logit = torch.where(v_t[:, None], logit, -math.inf)
            parts = []  # per 16-slot warp: max, exp-sum, sum of e_w exp(l - max) v rel
            for w in range(TILE // WARP):
                ws = slice(WARP * w, WARP * (w + 1))
                if not bool(v_t[ws].any()):
                    parts.append(None)  # no valid slot: the merge skips it
                    continue
                mx = logit[ws].max(0).values
                pexp = torch.exp(logit[ws] - mx)
                pw = pexp * ew_t[ws, None]
                parts.append((mx, pexp.sum(0), torch.einsum("eh,ec->hc", pw * val[ws], rel_t[ws])))
            for pos, (r, _, first, last) in enumerate(tile):
                if first:
                    m_run, d_run, o_run = (torch.full((HEADS,), -math.inf), torch.zeros(HEADS),
                                           torch.zeros(HEADS, 3))
                for part in parts[2 * pos:2 * pos + 2]:
                    if part is None:
                        continue
                    mw, sw, vw = part
                    mn = torch.maximum(m_run, mw)
                    a, b = torch.exp(m_run - mn), torch.exp(mw - mn)
                    d_run = d_run * a + sw * b
                    o_run = o_run * a[:, None] + vw * b[:, None]
                    m_run = mn
                if last:
                    delta = (o_run / d_run.clamp_min(1e-16)[:, None]).sum(0) / HEADS
                    out[r] = xr[r] + float(lig[r]) * delta
    return out.reshape(B, N, 3), walked


def _jax_h2x_bf16(model, h, x, nbh, mlig, e_w, n_ligand):
    block = state_dict_to_flax_params(model.net.state_dict())["params"]["refine_net"]["block_0"]
    _, jph = extract_layer_params(block, 128, 20)
    offsets, coeff = jax_offsets(0.0, 10.0, 20)
    etype = G.edge_types(nbh, mlig).argmax(-1).int().numpy()
    want = jax_h2x(jnp.asarray(h.numpy()), jnp.asarray(x.numpy()),
                   jnp.asarray(nbh.idx.int().numpy()), jnp.asarray(nbh.mask.numpy()),
                   jnp.asarray(etype), jnp.asarray(e_w.numpy()), jnp.asarray(mlig.numpy()),
                   offsets, jph, n_heads=16, coeff=coeff, dtype=jnp.bfloat16, interpret=True,
                   n_ligand=n_ligand)
    return torch.from_numpy(np.array(want, dtype=np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_h2x_bf16_replay_matches_plain_and_jax(case):
    cutoff_mode, k, n_protein, n_ligand = CASES[case]
    model, h, x, nbh, mlig, e_w = _case(cutoff_mode, k, n_protein, n_ligand)
    K = nbh.idx.shape[-1]
    assert K == (k if cutoff_mode == "knn" else n_ligand - 1 + k)
    layer = model.net.refine_net.base_block[0]
    with torch.no_grad():
        _, ph = edge_layer.pack_layer_params(layer, torch.bfloat16)
        got, walked = h2x_bf16_replay(h, x, nbh, mlig, e_w, ph, n_ligand)
        plain = edge_layer.h2x_layer_plain(layer, h, x, nbh, mlig, e_w, torch.bfloat16)
        f32 = edge_layer.h2x_layer_plain(layer, h, x, nbh, mlig, e_w)
    # the walk met what the case is for
    assert walked["empty_rows"] > 0 and walked["padded_rows"] > 0
    assert (walked["two_chunk_rows_in_a_tile"] > 0) == (K > KC)
    if K > 2 * KC:  # the ligand rows' valid edges come first: a row's last chunks can be dead
        assert walked["dead_chunks"] > 0
    if case != "hybrid_K40":  # there every ligand row has two live chunks, a tile of its own
        assert walked["two_row_tiles"] > 0
    assert (walked["partial_last_chunks"] > 0) == (K % KC != 0)
    assert torch.equal(got[:, :-n_ligand], x[:, :-n_ligand])  # protein rows never move
    empty = ~nbh.mask.any(-1)
    assert torch.equal(got[empty], x[empty])
    assert torch.equal(got[~mlig], x[~mlig])  # padded ligand rows keep x
    rows = mlig & ~empty
    assert bool(rows.any())
    assert rel(got, plain, rows) < BAR
    # the displacements too, each against its own scale
    assert rel(got - x, plain - x, rows) < BAR
    # bf16 rounding points, not the float32 layer's: the displacements sit
    # ~1e-6 of their scale from the bf16 plain layer, ~5e-3 from float32
    assert 4 * rel(got - x, plain - x, rows) < rel(got - x, f32 - x, rows)

    # the JAX per-layer kernel in bf16, interpret mode, same weights
    want = _jax_h2x_bf16(model, h, x, nbh, mlig, e_w, n_ligand)
    assert rel(got, want, rows) < BAR and rel(got - x, want - x, rows) < BAR
    assert rel(plain, want, rows) < BAR
