"""Per-layer attention sub-layers: the CUDA kernels of csrc/edge_layer.cu for
CUDA tensors, the eager layer of one `AttentionLayerO2TwoUpdateNodeGeneral`
with the edge weights given for CPU tensors. Replaces
targetdiff_tpu/ops/pallas/edge_layer.py (`x2h_attention_layer`,
`h2x_attention_layer`).

They run where the whole-block kernels do not: graphs wider than the block
kernels' 32 neighbours (the hybrid graph, K = max_ligand - 1 + k) and the
per-layer training path. The weights of one layer's pass are
`pack_layer_params` stacks with a leading layer axis of 1 (the counterpart
of targetdiff_tpu/models/fast_forward.py:extract_layer_params); a slice
`l:l+1` of `pack_block_params`' stacks is the same thing.

`dtype=torch.bfloat16` (the sampling path's default) launches the bf16
instantiations (`td_x2h_layer_bf16`, `td_h2x_layer_bf16`) on stacks packed
in bf16 and runs the bf16 plain layer on the CPU; bf16 launches are counted
apart (`BF16_X2H_LAUNCHES`, `BF16_H2X_LAUNCHES`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...models.uni_transformer import edge_geometry
from .. import graph as G
from ..precision import check_dtype
from ..rbf import gaussian_smearing_offsets
from . import build
from .block_denoiser import (HEADS, HIDDEN, _pack_pass, _pass_structs, _PassParams, entry,
                             require_pack)

X2H_LAUNCHES = 0  # float32 x2h_layer_cuda launches since the last reset
H2X_LAUNCHES = 0  # float32 h2x_layer_cuda launches since the last reset
BF16_X2H_LAUNCHES = BF16_H2X_LAUNCHES = 0  # the same of the bf16 kernels

MAX_LAYER_K = 256  # neighbours per row the per-layer kernels take (csrc kMaxLayerK)


def pack_layer_params(layer, dtype=torch.float32):
    """(x2h, h2x) weight stacks of one AttentionLayerO2TwoUpdateNodeGeneral,
    each field with a leading axis of 1, laid out as `_pack_pass`, for the
    kernels of `dtype`; differentiable."""
    return _pack_pass([layer], "h", dtype), _pack_pass([layer], "x", dtype)


def x2h_layer_plain(layer, h, x, nbh, mask_ligand, e_w, dtype=torch.float32):
    """The eager x2h sub-layer of `layer` with e_w [B,N,K] given."""
    edge_attr = G.edge_types(nbh, mask_ligand)
    _, r_feat = edge_geometry(x, nbh, edge_attr)
    return layer.x2h_layers[0](h, r_feat, edge_attr, nbh, e_w[..., None], dtype)


def h2x_layer_plain(layer, h, x, nbh, mask_ligand, e_w, dtype=torch.float32):
    """The eager h2x sub-layer of `layer` with e_w given: x moved on the
    ligand rows."""
    edge_attr = G.edge_types(nbh, mask_ligand)
    rel_x, r_feat = edge_geometry(x, nbh, edge_attr)
    delta = layer.h2x_layers[0](h, rel_x, r_feat, edge_attr, nbh, e_w[..., None], dtype)
    return x + delta * mask_ligand[..., None].to(x.dtype)


def x2h_attention_layer(layer, h, x, nbh, mask_ligand, e_w, params=None, dtype=torch.float32):
    """h [B,N,H] -> h' [B,N,H] by the x2h sub-layer of `layer`; nbh and e_w
    are [B,N,K]. `params`: the pass's weights packed for `dtype` (packed
    from `layer` when None). dtype: the products' precision."""
    check_dtype(dtype)
    if h.device.type == "cpu":
        return x2h_layer_plain(layer, h, x, nbh, mask_ligand, e_w, dtype)
    if params is None:
        with torch.no_grad():
            params = _pack_pass([layer], "h", dtype)
    return x2h_layer_cuda(h, x, nbh, mask_ligand, e_w, params, dtype)


def h2x_attention_layer(layer, h, x, nbh, mask_ligand, e_w, n_ligand: int, params=None,
                        dtype=torch.float32):
    """x [B,N,3] -> x' by the h2x sub-layer of `layer`; only the ligand rows
    (the last `n_ligand`, gated by mask_ligand) move."""
    check_dtype(dtype)
    if h.device.type == "cpu":
        return h2x_layer_plain(layer, h, x, nbh, mask_ligand, e_w, dtype)
    if params is None:
        with torch.no_grad():
            params = _pack_pass([layer], "x", dtype)
    return h2x_layer_cuda(h, x, nbh, mask_ligand, e_w, n_ligand, params, dtype)


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.load_library()
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    common = [vp, vp, vp, vp, vp, vp, vp, f32, _PassParams, i32, i32, i32]
    fns = {}
    # h, x, idx, nmask, mlig, ew, offsets, coeff, PassParams, B, N, K, [n_ligand,]
    # ni, nj, q, out, stream
    for name, extra in (("td_x2h_layer", []), ("td_h2x_layer", [i32])):
        for dtype in (torch.float32, torch.bfloat16):
            fn = getattr(lib, entry(name, dtype))
            fn.argtypes, fn.restype = common + extra + [vp, vp, vp, vp, vp], ctypes.c_int
            fns[entry(name, dtype)] = fn
    return fns


def check_layer_inputs(h, x, nbh, mask_ligand, e_w, params, dtype=torch.float32):
    """Raise unless the inputs are what the per-layer kernels of `dtype` take."""
    require_pack(params["w_node"].dtype, dtype)
    for name, t in (("h", h), ("x", x), ("idx", nbh.idx), ("nbr_mask", nbh.mask),
                    ("mask_ligand", mask_ligand), ("e_w", e_w), ("params", params["w_node"])):
        build.require_cuda(t, name)
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
    B, N, H = h.shape
    K = nbh.idx.shape[-1]
    if H != HIDDEN or params["w2k"].shape[-1] != HIDDEN or params["w_node"].shape[0] != 1:
        raise ValueError(f"the per-layer kernels take hidden={HIDDEN}, {HEADS} heads and one "
                         f"layer's packed weights; got h {tuple(h.shape)}, "
                         f"w_node {tuple(params['w_node'].shape)}")
    if not 0 < K <= MAX_LAYER_K:
        raise ValueError(f"the per-layer kernels take 1 <= K <= {MAX_LAYER_K}, got K={K}")
    if N <= 0:
        raise ValueError(f"the per-layer kernels take N >= 1 nodes, got N={N}")
    if h.dtype != torch.float32 or x.dtype != torch.float32 or x.shape != (B, N, 3):
        raise ValueError("h [B,N,H] and x [B,N,3] must be float32")
    if nbh.idx.dtype != torch.int64 or nbh.idx.shape != (B, N, K) or nbh.mask.shape != (B, N, K):
        raise ValueError("idx must be int64 [B,N,K] with a bool mask of the same shape")
    if (nbh.mask.dtype != torch.bool or mask_ligand.dtype != torch.bool
            or mask_ligand.shape != (B, N)):
        raise ValueError("nbr_mask and mask_ligand must be bool")
    if e_w.shape != (B, N, K) or e_w.dtype != torch.float32:
        raise ValueError("e_w must be float32 [B,N,K]")


def _launch(name, h, x, nbh, mask_ligand, e_w, params, out, *extra):
    name = entry(name, params["w_node"].dtype)
    B, N, H = h.shape
    K = nbh.idx.shape[-1]
    dev = h.device
    offsets, coeff = gaussian_smearing_offsets(device=dev)
    h, x = h.detach().contiguous(), x.detach().contiguous()
    idx, nmask, mlig = nbh.idx.contiguous(), nbh.mask.contiguous(), mask_ligand.contiguous()
    ew = e_w.detach().contiguous()
    ni = torch.empty((B * N, 2 * H), dtype=torch.float32, device=dev)
    nj = torch.empty_like(ni)
    q = torch.empty((B * N, H), dtype=torch.float32, device=dev)
    build.check(_entries()[name](
        h.data_ptr(), x.data_ptr(), idx.data_ptr(), nmask.data_ptr(), mlig.data_ptr(),
        ew.data_ptr(), offsets.data_ptr(), coeff, _pass_structs(params, 1)[0], B, N, K, *extra,
        ni.data_ptr(), nj.data_ptr(), q.data_ptr(), out.data_ptr(), build.stream_ptr(dev)), name)


def x2h_layer_cuda(h, x, nbh, mask_ligand, e_w, params, dtype=torch.float32):
    """The x2h kernel of `dtype`: h' [B,N,H] = h + the attention average of
    every row. No autograd graph (ops/kernels/edge_layer_vjp.py
    differentiates the float32 one)."""
    global X2H_LAUNCHES, BF16_X2H_LAUNCHES
    check_layer_inputs(h, x, nbh, mask_ligand, e_w, params, dtype)
    out = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    _launch("td_x2h_layer", h, x, nbh, mask_ligand, e_w, params, out)
    if dtype == torch.bfloat16:
        BF16_X2H_LAUNCHES += 1
    else:
        X2H_LAUNCHES += 1
    return out


def h2x_layer_cuda(h, x, nbh, mask_ligand, e_w, n_ligand: int, params, dtype=torch.float32):
    """The h2x kernel of `dtype` on the last `n_ligand` rows: x' [B,N,3],
    protein rows equal to x. No autograd graph."""
    global H2X_LAUNCHES, BF16_H2X_LAUNCHES
    check_layer_inputs(h, x, nbh, mask_ligand, e_w, params, dtype)
    if not 0 < n_ligand <= h.shape[1]:
        raise ValueError(f"n_ligand={n_ligand} must lie in [1, N={h.shape[1]}]")
    out = x.detach().contiguous().clone()
    _launch("td_h2x_layer", h, x, nbh, mask_ligand, e_w, params, out, n_ligand)
    if dtype == torch.bfloat16:
        BF16_H2X_LAUNCHES += 1
    else:
        H2X_LAUNCHES += 1
    return out
