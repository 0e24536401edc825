"""The port's plain block (UniTransformerO2TwoUpdateGeneral.block_forward,
the plain version of the CUDA block kernels) against the JAX block-denoiser
megakernel in interpret mode and the XLA UniTransformerO2 module; and the
kernels' packed-weight arithmetic, replayed in PyTorch, against the plain
block."""

import math

import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from targetdiff_tpu.models.fast_forward import extract_block_params
from targetdiff_tpu.models.uni_transformer import (
    UniTransformerO2TwoUpdateGeneral as JaxUniTransformer,
)
from targetdiff_tpu.ops import graph as JG
from targetdiff_tpu.ops.pallas.block_denoiser import block_denoiser as jax_block_denoiser
from targetdiff_tpu.ops.rbf import gaussian_smearing_offsets as jax_offsets
from targetdiff_tpu_torch.models.uni_transformer import masked_neighbor_softmax
from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels.block_denoiser import block_denoiser, pack_block_params
from targetdiff_tpu_torch.ops.rbf import gaussian_smearing, gaussian_smearing_offsets
from tests.test_torch_score_model import small_setup

torch.set_num_threads(2)


def _block_inputs():
    cfg, _, params, jbatch, model, _ = small_setup()
    rng = np.random.default_rng(3)
    B, NP_ = jbatch.protein_mask.shape
    NL = jbatch.ligand_mask.shape[1]
    N, H = NP_ + NL, cfg.hidden_dim
    h = rng.normal(size=(B, N, H)).astype(np.float32)
    x = np.concatenate([np.asarray(jbatch.protein_pos), np.asarray(jbatch.ligand_pos)], 1)
    node_mask = np.concatenate([np.asarray(jbatch.protein_mask), np.asarray(jbatch.ligand_mask)], 1)
    mlig = node_mask & (np.arange(N) >= NP_)[None]
    nbh = JG.knn_graph(jnp.asarray(x), jnp.asarray(node_mask), cfg.knn)
    return cfg, params, model, h, x, node_mask, mlig, np.asarray(nbh.idx), np.asarray(nbh.mask)


def _port_block(model, h, x, mlig, idx, nmask, n_ligand):
    nbh = G.Neighborhood(torch.tensor(idx, dtype=torch.int64), torch.tensor(nmask))
    with torch.no_grad():
        h2, x2 = block_denoiser(model.net.refine_net, torch.from_numpy(h), torch.from_numpy(x),
                                nbh, torch.from_numpy(mlig), n_ligand=n_ligand)
    return h2.numpy(), x2.numpy()


def test_plain_block_matches_pallas_megakernel_and_xla():
    cfg, params, model, h, x, node_mask, mlig, idx, nmask = _block_inputs()
    L, H, NL = cfg.num_layers, cfg.hidden_dim, model.max_ligand
    h_port, x_port = _port_block(model, h, x, mlig, idx, nmask, NL)

    rp = params["params"]["refine_net"]
    ew_p, block_p = extract_block_params(rp, L, H, cfg.num_r_gaussian, dtype=jnp.float32,
                                         n_heads=cfg.n_heads)
    offsets, coeff = jax_offsets(0.0, cfg.r_max, cfg.num_r_gaussian)
    h_pl, x_pl = jax_block_denoiser(
        jnp.asarray(h), jnp.asarray(x), jnp.asarray(idx), jnp.asarray(nmask), jnp.asarray(mlig),
        offsets, ew_p, block_p, num_layers=L, n_heads=cfg.n_heads, coeff=coeff,
        dtype=jnp.float32, interpret=True, n_ligand=NL)
    xla = JaxUniTransformer(
        num_blocks=1, num_layers=L, hidden_dim=H, n_heads=cfg.n_heads, k=cfg.knn,
        num_r_gaussian=cfg.num_r_gaussian, edge_feat_dim=4, cutoff_mode="knn",
        ew_net_type="global", x2h_out_fc=False, r_max=cfg.r_max,
    ).apply({"params": rp}, jnp.asarray(h), jnp.asarray(x), jnp.asarray(mlig),
            jnp.asarray(node_mask))

    m = node_mask[..., None]  # fully masked rows are implementation-defined
    for h_ref, x_ref in ((h_pl, x_pl), (xla["h"], xla["x"])):
        np.testing.assert_allclose(x_port * m, np.asarray(x_ref) * m, atol=2e-4, rtol=1e-3)
        np.testing.assert_allclose(h_port * m, np.asarray(h_ref) * m, atol=2e-3, rtol=1e-2)
    assert np.abs(x_port - x)[mlig].max() > 1e-3  # the ligand really moved


def _kernel_arithmetic(rn, packed, h, x, nbh, mlig):
    """The CUDA kernels' arithmetic on the packed weights: per-node
    projections gathered per edge, the edge-type RBF table, max-shifted
    softmax, h2x gated by the ligand mask."""
    B, N, H = h.shape
    NH, DH = rn.n_heads, H // rn.n_heads
    offsets, coeff = gaussian_smearing_offsets()
    idx, valid = nbh.idx, nbh.mask
    src_lig = torch.gather(mlig[:, None, :].expand(-1, N, -1), 2, idx)
    dst_lig = mlig[:, :, None]
    et = torch.where(src_lig, torch.where(dst_lig, 0, 1), torch.where(dst_lig, 2, 3))

    def geometry(xx):
        rel = xx[:, :, None] - G.gather_nodes(xx, idx)
        return rel, gaussian_smearing(torch.sqrt((rel * rel).sum(-1) + 1e-16), offsets, coeff)

    def ln_relu(z, scale, bias):
        return F.layer_norm(z, (z.shape[-1],), scale, bias).relu()

    w1, b1, ln, w2, b2 = packed.ew
    ew = torch.sigmoid(ln_relu(geometry(x)[1] @ w1 + b1, ln[0], ln[1]) @ w2 + b2)

    def attention(hh, xx, P, l):
        proj = hh @ P["w_node"][l] + P["b_node"][l]
        q = ln_relu(proj[..., 4 * H:], *P["q_ln"][l]) @ P["w_q2"][l] + P["b_q2"][l]
        rel, rbf = geometry(xx)
        z = (proj[..., None, :2 * H] + G.gather_nodes(proj[..., 2 * H:4 * H], idx)
             + P["w_et"][l][et] + torch.einsum("bnkr,bnkrc->bnkc", rbf, P["w_rbf"][l][et]))
        kv_s, kv_b = P["kv_ln"][l]
        k = ln_relu(z[..., :H], kv_s[:H], kv_b[:H]) @ P["w2k"][l] + P["b2k"][l]
        v = ln_relu(z[..., H:], kv_s[H:], kv_b[H:]) @ P["w2v"][l] + P["b2v"][l]
        logits = (q[:, :, None] * k).reshape(B, N, -1, NH, DH).sum(-1) / math.sqrt(DH)
        return masked_neighbor_softmax(logits, valid) * ew[..., None], v, rel

    for l in range(packed.x2h["w_node"].shape[0]):
        a, v, _ = attention(h, x, packed.x2h, l)
        h = h + (a[..., None] * v.reshape(B, N, -1, NH, DH)).sum(2).reshape(B, N, H)
        a, v, rel = attention(h, x, packed.h2x, l)
        x = x + torch.einsum("bnk,bnkd->bnd", (a * v).mean(-1), rel) * mlig[..., None]
    return h, x


def test_packed_kernel_weights_reproduce_plain_block():
    _, _, model, h, x, node_mask, mlig, idx, nmask = _block_inputs()
    rn = model.net.refine_net
    nbh = G.Neighborhood(torch.tensor(idx, dtype=torch.int64), torch.tensor(nmask))
    th, tx, tm = torch.from_numpy(h), torch.from_numpy(x), torch.from_numpy(mlig)
    with torch.no_grad():
        h_ref, x_ref = rn.block_forward(th, tx, nbh, tm)
        h_k, x_k = _kernel_arithmetic(rn, pack_block_params(rn), th, tx, nbh, tm)
    m = node_mask[..., None]
    np.testing.assert_allclose(x_k.numpy() * m, x_ref.numpy() * m, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h_k.numpy() * m, h_ref.numpy() * m, atol=1e-4, rtol=1e-4)
