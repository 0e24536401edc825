"""The block-VJP kernel's algorithm (csrc/block_vjp.cu, float32 and its
bf16 instantiation), replayed by hand in PyTorch on the packed weights:
`replay_block_bwd` takes layers L-1..0 from the train-mode checkpoints,
`_pass_bwd` one pass of one layer as edge_bwd_kernel, gather_kernel,
node_bwd_kernel and the weight-gradient reductions compute it, with
bf16=True rounding each product's operands where the bf16 kernels round.
A reference, not a path of the program: the tests and chip_smoke.py hold
the kernel against it, on the CPU or on the card (the device of its
inputs), as a second witness beside autograd of the plain block."""

import math

import torch
import torch.nn.functional as F

from targetdiff_tpu_torch.ops import graph as G
from targetdiff_tpu_torch.ops.kernels.block_denoiser import WEIGHT_FIELDS
from targetdiff_tpu_torch.ops.kernels.block_vjp import FIELDS
from targetdiff_tpu_torch.ops.precision import round_bf16
from targetdiff_tpu_torch.ops.rbf import gaussian_smearing, gaussian_smearing_offsets


def _ln_bwd(dy, zhat, rstd, scale):
    """LayerNorm backward to its input, given d(output) after ReLU's mask."""
    dzh = dy * scale
    return rstd * (dzh - dzh.mean(-1, keepdim=True) - zhat * (dzh * zhat).mean(-1, keepdim=True))


def _ln(z, eps=1e-5):
    mu = z.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((z - mu) ** 2).mean(-1, keepdim=True) + eps)
    return (z - mu) * rstd, rstd


def drbf_einsum(dz, w_rbf, et, ta):
    """d rbf[e][r] = dz[e] . w_rbf[et[e]][r]: dz [.., 2H], w_rbf [4, R, 2H], et
    the edge types [..] (ta, the row's kind, unused)."""
    return torch.einsum("...c,...rc->...r", dz, w_rbf[et])


def _pass_bwd(P, l, h, x, idx, nmask, mlig, e_w, row0, h2x, dh, dx, dew, grads, n_heads,
              matmul=torch.matmul, drbf_fn=drbf_einsum, node_matmul=torch.matmul, bf16=False,
              tmatmul=torch.matmul):
    """One pass of layer l, as edge_bwd_kernel + gather_kernel +
    node_bwd_kernel + the weight-gradient reductions compute it; the
    recompute's k and v second layers through `matmul`, the transposed
    second layers (da = d W2^T) through `tmatmul(d, W2^T)`, d rbf through
    `drbf_fn(dz, w_rbf, et, ta)`, the node kernel's two products through
    `node_matmul`. bf16=True: as the bf16 kernels (run_pass<kH2X, true>)
    round, every product's operands rounded to bf16 (the recompute's node
    projections, RBF table and second layers, the transposed second layers,
    d rbf, the node kernel's products and the weight gradients), sums,
    LayerNorm, softmax and d dist float32."""
    B, N, H = h.shape
    NH, DH = n_heads, H // n_heads
    offsets, coeff = gaussian_smearing_offsets(h.device)
    r = round_bf16 if bf16 else (lambda t: t)
    w = {f: r(P[f][l]) if f in WEIGHT_FIELDS else P[f][l] for f in FIELDS}
    g = {f: grads[f][l] for f in FIELDS}
    # node projections and the query MLP (node_kernel)
    proj = r(h) @ w["w_node"] + w["b_node"]
    ni, nj, q1 = proj[..., :2 * H], proj[..., 2 * H:4 * H], proj[..., 4 * H:]
    q1hat, q1rstd = _ln(q1)
    yq = q1hat * w["q_ln"][0] + w["q_ln"][1]
    qa = yq.relu()
    q = r(qa) @ w["w_q2"] + w["b_q2"]
    # edges of the pass's destination rows (edge_bwd_kernel, forward part)
    rows = slice(row0, N)
    idx_r, valid, ew = idx[:, rows], nmask[:, rows], e_w[:, rows]
    rel = x[:, rows, None] - G.gather_nodes(x, idx_r)
    dist = torch.sqrt((rel * rel).sum(-1) + 1e-16)
    rbf = gaussian_smearing(dist, offsets, coeff)
    src_lig = torch.gather(mlig[:, None, :].expand(-1, N - row0, -1), 2, idx_r)
    dst_lig = mlig[:, rows, None]
    et = torch.where(src_lig, torch.where(dst_lig, 0, 1), torch.where(dst_lig, 2, 3))
    z = (ni[:, rows, None] + G.gather_nodes(nj, idx_r) + w["w_et"][et]
         + torch.einsum("bnkr,bnkrc->bnkc", r(rbf), w["w_rbf"][et]))
    zh_k, rs_k = _ln(z[..., :H])
    zh_v, rs_v = _ln(z[..., H:])
    kvs, kvb = w["kv_ln"]
    y_k, y_v = zh_k * kvs[:H] + kvb[:H], zh_v * kvs[H:] + kvb[H:]
    a_k, a_v = y_k.relu(), y_v.relu()
    k = matmul(r(a_k), w["w2k"]) + w["b2k"]
    v = matmul(r(a_v), w["w2v"]) + w["b2v"]
    logits = (q[:, rows, None] * k).reshape(*k.shape[:3], NH, DH).sum(-1) / math.sqrt(DH)
    logits = torch.where(valid[..., None], logits, torch.full((), -1e30, device=h.device))
    unnorm = torch.where(valid[..., None], torch.exp(logits - logits.amax(2, keepdim=True)), 0.0)
    alpha = unnorm / unnorm.sum(2, keepdim=True).clamp(min=1e-16)
    # output cotangent -> P (d alpha = e_w P) and dv
    if not h2x:
        gc = dh[:, rows, None]
        Pm = (gc * v).reshape(*v.shape[:3], NH, DH).sum(-1)
        dv = gc * alpha.repeat_interleave(DH, -1) * ew[..., None]
        gd = sdir = None
    else:
        gd = dx[:, rows] * mlig[:, rows, None]
        ds = (gd[:, :, None] * rel).sum(-1) / NH
        Pm = ds[..., None] * v
        dv = ds[..., None] * alpha * ew[..., None]
        sdir = (alpha * ew[..., None] * v).sum(-1) / NH
    dew[:, rows] += (alpha * Pm).sum(-1)
    dot = (alpha * ew[..., None] * Pm).sum(2, keepdim=True)
    dl = (alpha * (ew[..., None] * Pm - dot) / math.sqrt(DH)).repeat_interleave(DH, -1)
    dq = torch.zeros_like(q)
    dq[:, rows] = (dl * k).sum(2)
    dk = dl * q[:, rows, None]
    # second layers and LayerNorm+ReLU
    g["w2k"] += torch.einsum("bnki,bnkj->ij", r(a_k), r(dk))
    g["b2k"] += dk.sum((0, 1, 2))
    g["w2v"] += torch.einsum("bnki,bnkj->ij", r(a_v), r(dv))
    g["b2v"] += dv.sum((0, 1, 2))
    dy_k = tmatmul(r(dk), w["w2k"].T) * (y_k > 0)
    dy_v = tmatmul(r(dv), w["w2v"].T) * (y_v > 0)
    dz = torch.cat([_ln_bwd(dy_k, zh_k, rs_k, kvs[:H]), _ln_bwd(dy_v, zh_v, rs_v, kvs[H:])], -1)
    g["kv_ln"][0] += torch.cat([(dy_k * zh_k).sum((0, 1, 2)), (dy_v * zh_v).sum((0, 1, 2))])
    g["kv_ln"][1] += torch.cat([dy_k.sum((0, 1, 2)), dy_v.sum((0, 1, 2))])
    # edge-type tables and the geometry
    oh = F.one_hot(et, 4).to(dz.dtype)
    g["w_rbf"] += torch.einsum("bnke,bnkr,bnkc->erc", oh, r(rbf), r(dz))
    g["w_et"] += torch.einsum("bnke,bnkc->ec", oh, r(dz))
    drbf = drbf_fn(r(dz), w["w_rbf"], et, torch.where(dst_lig, 0, 1).expand_as(et))
    ddist = (drbf * 2.0 * coeff * (dist[..., None] - offsets) * rbf).sum(-1)
    drel = (ddist / dist.clamp(min=1e-16))[..., None] * rel
    if h2x:
        drel = drel + gd[:, :, None] * sdir[..., None]
    dx[:, rows] += drel.sum(2)
    # the source side (gather_kernel): sums per source node
    dproj = torch.zeros_like(proj)
    dproj[:, rows, :2 * H] = dz.sum(2)
    flat = (idx_r + N * torch.arange(B, device=h.device)[:, None, None]).reshape(-1)
    dnj = torch.zeros(B * N, 2 * H, device=h.device).index_add_(0, flat, dz.reshape(-1, 2 * H))
    dproj[..., 2 * H:4 * H] = dnj.reshape(B, N, 2 * H)
    dsrc = torch.zeros(B * N, 3, device=h.device).index_add_(0, flat, drel.reshape(-1, 3))
    dx -= dsrc.reshape(B, N, 3)
    # query MLP and node projections backward (node_bwd_kernel)
    dyq = node_matmul(r(dq), w["w_q2"].T) * (yq > 0)
    dproj[..., 4 * H:] = _ln_bwd(dyq, q1hat, q1rstd, w["q_ln"][0])
    g["w_q2"] += torch.einsum("bni,bnj->ij", r(qa), r(dq))
    g["b_q2"] += dq.sum((0, 1))
    g["q_ln"][0] += (dyq * q1hat).sum((0, 1))
    g["q_ln"][1] += dyq.sum((0, 1))
    g["w_node"] += torch.einsum("bni,bnj->ij", r(h), r(dproj))
    g["b_node"] += dproj.sum((0, 1))
    dh += node_matmul(r(dproj), w["w_node"].T)


@torch.no_grad()
def replay_block_bwd(x2h, h2x, hck, xck, nbh, mlig, e_w, n_ligand, gh, gx, n_heads,
                     matmul=torch.matmul, drbf_fn=drbf_einsum, node_matmul=torch.matmul,
                     bf16=False, tmatmul=torch.matmul):
    """The backward kernel's algorithm: layers L-1..0, h2x pass on the
    ligand tail from hck[l+1], then x2h on every row from hck[l] (hck
    [L+1,B,N,H], xck [L+1,B,N,3]), the recompute's second layers through
    `matmul`, the transposed second layers through `tmatmul`, d rbf through
    `drbf_fn`, the node kernel's products through `node_matmul`; bf16=True:
    the bf16 kernel's (td_block_bwd_bf16) roundings (`_pass_bwd`). Returns
    (dh0, dx0, de_w, x2h grads, h2x grads)."""
    L, N = hck.shape[0] - 1, hck.shape[2]
    dh, dx, dew = gh.clone(), gx.clone(), torch.zeros_like(e_w)
    gx2h = {f: torch.zeros_like(x2h[f]) for f in FIELDS}
    gh2x = {f: torch.zeros_like(h2x[f]) for f in FIELDS}
    for l in reversed(range(L)):
        _pass_bwd(h2x, l, hck[l + 1], xck[l], nbh.idx, nbh.mask, mlig, e_w, N - n_ligand,
                  True, dh, dx, dew, gh2x, n_heads, matmul, drbf_fn, node_matmul, bf16,
                  tmatmul)
        _pass_bwd(x2h, l, hck[l], xck[l], nbh.idx, nbh.mask, mlig, e_w, 0, False, dh, dx,
                  dew, gx2h, n_heads, matmul, drbf_fn, node_matmul, bf16, tmatmul)
    return dh, dx, dew, gx2h, gh2x
