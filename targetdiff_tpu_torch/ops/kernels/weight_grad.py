"""Weight-gradient products of the attention backwards: out = X^T Y over the
rows of X [M, P] and Y [M, Q] (csrc/weight_grad.cuh, `weight_grad_kernel`
plus `reduce_kernel`). The backwards' `run_pass` (csrc/pass_bwd.cuh) runs
five of them per pass: the second layers w2k and w2v and the RBF /
edge-type table over edges, `w_node` and the query MLP's second layer over
nodes. They replace the parameter-gradient products of the TPU kernels
(targetdiff_tpu/ops/pallas/edge_layer_vjp.py:_cdotg, block_vjp.py).

`weight_grad_cuda` launches the product alone through the C entry
`td_weight_grad`, the path `run_pass` takes; `weight_grad_plain` is its plain
version. `LAUNCHES` counts the kernel's launches by class: the backwards'
wrappers add their passes' products (`count_passes`), `weight_grad_cuda`
adds under "alone". `dtype=torch.bfloat16` is the bf16 instantiation (the
bf16 backwards' products, JAX's _cdotg at cd=bf16: X and Y rounded to bf16,
float32 accumulation; `td_weight_grad_bf16`), counted in `BF16_LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..precision import check_dtype, round_bf16
from . import build

LAUNCHES = {"x2h_edge": 0, "h2x_edge": 0, "node": 0, "alone": 0}
BF16_LAUNCHES = dict.fromkeys(LAUNCHES, 0)  # the same of the bf16 instantiation
# products of one run_pass, by class: w2k, w2v and the table over the pass's
# edges; w_node and w_q2 over its nodes
PER_PASS = {"x2h": {"x2h_edge": 3, "node": 2}, "h2x": {"h2x_edge": 3, "node": 2}}


def count_passes(sub: str, passes: int, dtype=torch.float32) -> None:
    """Count the weight-gradient launches of `passes` run_pass calls of
    `sub` ('x2h' or 'h2x') of the backward of `dtype`."""
    counts = BF16_LAUNCHES if check_dtype(dtype) == torch.bfloat16 else LAUNCHES
    for name, n in PER_PASS[sub].items():
        counts[name] += n * passes


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.load_library()
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    size = lib.td_weight_grad_partial_floats
    size.argtypes, size.restype = [], i64
    fns = {}
    for dtype, name in ((torch.float32, "td_weight_grad"),
                        (torch.bfloat16, "td_weight_grad_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = [vp, i32, vp, i32, i64, i32, i32, vp, vp, vp]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    return size, fns


def weight_grad_plain(X, Y, dtype=torch.float32):
    """X^T Y in float32: X [M, P], Y [M, Q] -> [P, Q]; bf16: X and Y rounded
    to bf16 first."""
    X, Y = X.float(), Y.float()
    if check_dtype(dtype) == torch.bfloat16:
        X, Y = round_bf16(X), round_bf16(Y)
    return X.T @ Y


def _row_major(t, name):
    if t.dtype != torch.float32 or t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name} must be a float32 [M, columns] tensor with unit column "
                         f"stride, got {t.dtype} {tuple(t.shape)} strides {t.stride()}")
    return max(t.stride(0), t.shape[1])


def weight_grad_cuda(X, Y, out=None, dtype=torch.float32):
    """X^T Y on the kernel of `dtype`: X [M, P] and Y [M, Q] float32 CUDA
    tensors whose rows may be strided (column slices of wider rows, as
    run_pass passes them); out [P, Q] contiguous, allocated if None. Bases,
    row strides, P and Q must be multiples of 16 bytes: the C entry refuses
    others."""
    build.require_cuda(X, "X")
    build.require_cuda(Y, "Y")
    ldx, ldy = _row_major(X, "X"), _row_major(Y, "Y")
    (M, P), Q = X.shape, Y.shape[1]
    if Y.shape[0] != M or Y.device != X.device:
        raise ValueError(f"X {tuple(X.shape)} and Y {tuple(Y.shape)} disagree on their rows "
                         "or device")
    if out is None:
        out = torch.empty((P, Q), dtype=torch.float32, device=X.device)
    elif out.shape != (P, Q) or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous float32 [{P}, {Q}] tensor")
    size, fns = _entries()
    partial = torch.empty(size(), dtype=torch.float32, device=X.device)
    build.check(fns[check_dtype(dtype)](X.data_ptr(), ldx, Y.data_ptr(), ldy, M, P, Q,
                                        out.data_ptr(), partial.data_ptr(),
                                        build.stream_ptr(X.device)), "td_weight_grad")
    (BF16_LAUNCHES if dtype == torch.bfloat16 else LAUNCHES)["alone"] += 1
    return out
