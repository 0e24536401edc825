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
adds under "alone".
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

LAUNCHES = {"x2h_edge": 0, "h2x_edge": 0, "node": 0, "alone": 0}
# products of one run_pass, by class: w2k, w2v and the table over the pass's
# edges; w_node and w_q2 over its nodes
PER_PASS = {"x2h": {"x2h_edge": 3, "node": 2}, "h2x": {"h2x_edge": 3, "node": 2}}


def count_passes(sub: str, passes: int) -> None:
    """Count the weight-gradient launches of `passes` run_pass calls of
    `sub` ('x2h' or 'h2x')."""
    for name, n in PER_PASS[sub].items():
        LAUNCHES[name] += n * passes


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.load_library()
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    size = lib.td_weight_grad_partial_floats
    size.argtypes, size.restype = [], i64
    fn = lib.td_weight_grad
    fn.argtypes = [vp, i32, vp, i32, i64, i32, i32, vp, vp, vp]
    fn.restype = ctypes.c_int
    return size, fn


def weight_grad_plain(X, Y):
    """X^T Y in float32: X [M, P], Y [M, Q] -> [P, Q]."""
    return X.float().T @ Y.float()


def _row_major(t, name):
    if t.dtype != torch.float32 or t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name} must be a float32 [M, columns] tensor with unit column "
                         f"stride, got {t.dtype} {tuple(t.shape)} strides {t.stride()}")
    return max(t.stride(0), t.shape[1])


def weight_grad_cuda(X, Y, out=None):
    """X^T Y on the kernel: X [M, P] and Y [M, Q] float32 CUDA tensors whose
    rows may be strided (column slices of wider rows, as run_pass passes
    them); out [P, Q] contiguous, allocated if None. Bases, row strides, P
    and Q must be multiples of 16 bytes: the C entry refuses others."""
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
    size, fn = _entries()
    partial = torch.empty(size(), dtype=torch.float32, device=X.device)
    build.check(fn(X.data_ptr(), ldx, Y.data_ptr(), ldy, M, P, Q, out.data_ptr(),
                   partial.data_ptr(), build.stream_ptr(X.device)), "td_weight_grad")
    LAUNCHES["alone"] += 1
    return out
