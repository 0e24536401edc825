"""Differentiable per-layer attention sub-layers: `x2h_layer_trainable` and
`h2x_layer_trainable` return gradients to h, x, the edge weights and the
layer's parameters. Replaces targetdiff_tpu/ops/pallas/edge_layer_vjp.py
(the custom-VJP layers and their backward kernels `_x2h_bwd_kernel`,
`_h2x_bwd_kernel`).

For CUDA tensors, `_X2HLayer` / `_H2XLayer` (torch.autograd.Functions) run
the forward kernels of csrc/edge_layer.cu and, backward, csrc/
edge_layer_vjp.cu. They return the gradients of the layer's packed weight
stacks (`pack_layer_params`); autograd carries those back through the
packing into the nn.Parameters, as for the whole block (block_vjp.py). For
CPU tensors the plain eager sub-layers run under ordinary autograd.

`dtype=torch.bfloat16` (JAX's `x2h_layer_trainable(dtype=bf16)`, the
`fast_bf16_pl` route): the bf16 forward kernels and the bf16 backwards
(`td_{x2h,h2x}_layer_bwd_bf16`). As `_BlockLayers`, the Functions take the
float32 stacks and make the bf16 pack inside their forward, so the weight
gradients come back float32; the CPU version is the eager sub-layer with
dtype=torch.bfloat16 (precision.Bf16Linear). bf16 launches are counted
apart (`BF16_X2H_BWD_LAUNCHES`, `BF16_H2X_BWD_LAUNCHES`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from .. import graph as G
from ..rbf import gaussian_smearing_offsets
from . import build, weight_grad
from ..precision import check_dtype
from .block_denoiser import _pack_pass, _pass_structs, _PassParams, cast_pack, entry
from .block_vjp import (FIELDS, _grad_stacks, _grad_structs, _PassGrads, _PassT, _transposed,
                        count_library_launches, library_launch_counts)
from .edge_layer import (
    check_layer_inputs,
    h2x_layer_cuda,
    h2x_layer_plain,
    x2h_layer_cuda,
    x2h_layer_plain,
)

X2H_BWD_LAUNCHES = 0  # float32 x2h_layer_bwd_cuda launches since the last reset
H2X_BWD_LAUNCHES = 0  # float32 h2x_layer_bwd_cuda launches since the last reset
BF16_X2H_BWD_LAUNCHES = BF16_H2X_BWD_LAUNCHES = 0  # the same of the bf16 backwards

MAX_NODES = 4096  # nodes per complex the backwards' inverse adjacency takes (csrc kAdjMaxN)


def x2h_layer_trainable(layer, h, x, nbh: G.Neighborhood, mask_ligand, e_w,
                        dtype=torch.float32):
    """The x2h sub-layer of `layer`, differentiable: h [B,N,H], x [B,N,3],
    e_w [B,N,K]; dtype the products' precision in both directions. Returns
    h'."""
    check_dtype(dtype)
    if h.device.type == "cpu":
        return x2h_layer_plain(layer, h, x, nbh, mask_ligand, e_w, dtype)
    p = _pack_pass([layer], "h")
    return _X2HLayer.apply(h, x, e_w, nbh.idx, nbh.mask, mask_ligand, dtype,
                           *[p[f] for f in FIELDS])


def h2x_layer_trainable(layer, h, x, nbh: G.Neighborhood, mask_ligand, e_w, n_ligand: int,
                        dtype=torch.float32):
    """The h2x sub-layer of `layer`, differentiable, on the last `n_ligand`
    rows; dtype as `x2h_layer_trainable`. Returns x'."""
    check_dtype(dtype)
    if h.device.type == "cpu":
        return h2x_layer_plain(layer, h, x, nbh, mask_ligand, e_w, dtype)
    p = _pack_pass([layer], "x")
    return _H2XLayer.apply(h, x, e_w, nbh.idx, nbh.mask, mask_ligand, n_ligand, dtype,
                           *[p[f] for f in FIELDS])


class _X2HLayer(torch.autograd.Function):
    """The x2h kernels of `dtype` on the float32 stacks (the pack made here)."""

    @staticmethod
    def forward(ctx, h, x, e_w, idx, nmask, mlig, dtype, *flat):
        params = cast_pack(dict(zip(FIELDS, flat)), dtype)
        ctx.save_for_backward(h, x, e_w, idx, nmask, mlig, *[params[f] for f in FIELDS])
        ctx.dtype = dtype
        return x2h_layer_cuda(h, x, G.Neighborhood(idx, nmask), mlig, e_w, params, dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h, x, e_w, idx, nmask, mlig, *flat = ctx.saved_tensors
        dh, dx, dew, grads = x2h_layer_bwd_cuda(h, x, G.Neighborhood(idx, nmask), mlig, e_w,
                                                dict(zip(FIELDS, flat)), g, ctx.dtype)
        return (dh, dx, dew, None, None, None, None, *[grads[f] for f in FIELDS])


class _H2XLayer(torch.autograd.Function):
    """The h2x kernels of `dtype` on the float32 stacks (the pack made here)."""

    @staticmethod
    def forward(ctx, h, x, e_w, idx, nmask, mlig, n_ligand, dtype, *flat):
        params = cast_pack(dict(zip(FIELDS, flat)), dtype)
        ctx.save_for_backward(h, x, e_w, idx, nmask, mlig, *[params[f] for f in FIELDS])
        ctx.n_ligand, ctx.dtype = n_ligand, dtype
        return h2x_layer_cuda(h, x, G.Neighborhood(idx, nmask), mlig, e_w, n_ligand, params,
                              dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h, x, e_w, idx, nmask, mlig, *flat = ctx.saved_tensors
        dh, dx, dew, grads = h2x_layer_bwd_cuda(h, x, G.Neighborhood(idx, nmask), mlig, e_w,
                                                ctx.n_ligand, dict(zip(FIELDS, flat)), g,
                                                ctx.dtype)
        return (dh, dx, dew, None, None, None, None, None, *[grads[f] for f in FIELDS])


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.load_library()
    vp, i32, f32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    ws = lib.td_block_bwd_workspace
    ws.argtypes = [i32, i32, i32, i32, i32, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    ws.restype = None
    fns = {"workspace": ws}
    # h, x, idx, nmask, mlig, ew, offsets, coeff, PassParams, PassT, PassGrads, B, N, K,
    # [n_ligand,] g, dh, dx, dew, work, work_floats, iwork, iwork_ints, stream
    common = [vp, vp, vp, vp, vp, vp, vp, f32, _PassParams, _PassT, _PassGrads, i32, i32, i32]
    for name, extra in (("td_x2h_layer_bwd", []), ("td_h2x_layer_bwd", [i32])):
        for dtype in (torch.float32, torch.bfloat16):
            fn = getattr(lib, entry(name, dtype))
            fn.argtypes = common + extra + [vp, vp, vp, vp, vp, i64, vp, i64, vp]
            fn.restype = ctypes.c_int
            fns[entry(name, dtype)] = fn
    return fns


def _layer_bwd(name, h, x, nbh, mlig, e_w, params, g, n_ligand, dtype):
    """Runs one per-layer backward entry of `dtype` (params packed for it);
    returns (dh, dx, de_w, float32 grads of the packed stacks)."""
    check_layer_inputs(h, x, nbh, mlig, e_w, params, dtype)
    name = entry(name, dtype)
    B, N, H = h.shape
    if N > MAX_NODES:
        raise ValueError(f"the per-layer backwards take N <= {MAX_NODES} nodes, got N={N}")
    K = nbh.idx.shape[-1]
    dev = h.device
    fns = _entries()
    nf, ni = ctypes.c_longlong(), ctypes.c_longlong()
    fns["workspace"](B, N, K, n_ligand or 1, 1, ctypes.byref(nf), ctypes.byref(ni))
    work = torch.empty(nf.value, dtype=torch.float32, device=dev)
    iwork = torch.empty(ni.value, dtype=torch.int32, device=dev)
    offsets, coeff = gaussian_smearing_offsets(device=dev)
    grads = _grad_stacks(params)
    pt = _transposed(params)
    h, x, g = h.detach().contiguous(), x.detach().contiguous(), g.float().contiguous()
    idx, nmask, mlig = nbh.idx.contiguous(), nbh.mask.contiguous(), mlig.contiguous()
    ew = e_w.detach().contiguous()
    dh = torch.empty((B, N, H), dtype=torch.float32, device=dev)
    dx = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    dew = torch.empty((B, N, K), dtype=torch.float32, device=dev)
    extra = [] if n_ligand is None else [n_ligand]
    since = library_launch_counts()
    build.check(fns[name](
        h.data_ptr(), x.data_ptr(), idx.data_ptr(), nmask.data_ptr(), mlig.data_ptr(),
        ew.data_ptr(), offsets.data_ptr(), coeff, _pass_structs(params, 1)[0],
        _PassT(*[pt[f][0].data_ptr() for f, _ in _PassT._fields_]), _grad_structs(grads, 1)[0],
        B, N, K, *extra, g.data_ptr(), dh.data_ptr(), dx.data_ptr(), dew.data_ptr(),
        work.data_ptr(), nf.value, iwork.data_ptr(), ni.value, build.stream_ptr(dev)), name)
    count_library_launches(since)
    return dh, dx, dew, grads


def x2h_layer_bwd_cuda(h, x, nbh, mask_ligand, e_w, params, g, dtype=torch.float32):
    """The x2h backward kernel of `dtype` (params packed for it): g [B,N,H]
    the cotangent of h'. Returns (dh, dx, de_w, gradients of the packed
    stacks), float32."""
    global X2H_BWD_LAUNCHES, BF16_X2H_BWD_LAUNCHES
    out = _layer_bwd("td_x2h_layer_bwd", h, x, nbh, mask_ligand, e_w, params, g, None, dtype)
    if dtype == torch.bfloat16:
        BF16_X2H_BWD_LAUNCHES += 1
    else:
        X2H_BWD_LAUNCHES += 1
    weight_grad.count_passes("x2h", 1, dtype)
    return out


def h2x_layer_bwd_cuda(h, x, nbh, mask_ligand, e_w, n_ligand: int, params, g,
                       dtype=torch.float32):
    """The h2x backward kernel of `dtype` on the last `n_ligand` rows: g
    [B,N,3] the cotangent of x'. Returns (dh, dx, de_w, gradients of the
    packed stacks), float32."""
    global H2X_BWD_LAUNCHES, BF16_H2X_BWD_LAUNCHES
    if not 0 < n_ligand <= h.shape[1]:
        raise ValueError(f"n_ligand={n_ligand} must lie in [1, N={h.shape[1]}]")
    out = _layer_bwd("td_h2x_layer_bwd", h, x, nbh, mask_ligand, e_w, params, g, n_ligand, dtype)
    if dtype == torch.bfloat16:
        BF16_H2X_BWD_LAUNCHES += 1
    else:
        H2X_BWD_LAUNCHES += 1
    weight_grad.count_passes("h2x", 1, dtype)
    return out
