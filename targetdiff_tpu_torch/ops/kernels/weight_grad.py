"""Weight-gradient products of the attention backwards: out = X^T Y over the
rows of X [M, P] and Y [M, Q] (csrc/weight_grad.cuh, `weight_grad_kernel`,
whose float32 clusters fold their chunks' partials in shared memory, plus
`reduce_kernel`). The backwards' `run_pass` (csrc/pass_bwd.cuh) runs
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
`plan(M, P, Q)` is the split the card takes for a product (row chunks,
clusters, the partials reduce_kernel sums; `td_weight_grad_partials`),
`colsum_partials(M, Q)` that of run_pass's column sums; `reduce_partials`
runs reduce_kernel alone beside its plain version `reduce_plain`.
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
    fns = {"plan": lib.td_weight_grad_partials, "colsum": lib.td_colsum_partials,
           "reduce": lib.td_reduce_partials}
    fns["plan"].argtypes = [i64, i32, i32, i32, ctypes.POINTER(i64)]
    fns["plan"].restype = ctypes.c_int
    fns["colsum"].argtypes, fns["colsum"].restype = [i64, i32], i64
    fns["reduce"].argtypes, fns["reduce"].restype = [vp, i32, i64, vp, vp], ctypes.c_int
    for dtype, name in ((torch.float32, "td_weight_grad"),
                        (torch.bfloat16, "td_weight_grad_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = [vp, i32, vp, i32, i64, i32, i32, vp, vp, vp]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    return size, fns


PLAN_FIELDS = ("partials", "chunks", "chunk_rows", "cluster", "cluster_wave", "groups")


def plan(M: int, P: int, Q: int, dtype=torch.float32) -> dict:
    """The split the kernel of `dtype` takes for X^T Y over M rows, X [M, P],
    Y [M, Q], on this card (csrc/weight_grad.cuh wg_plan,
    td_weight_grad_partials): `chunks` row chunks of `chunk_rows` rows in
    clusters of `cluster` (2 in float32, 1 in bf16), one partial [P, Q] a
    cluster (`partials`) for reduce_kernel, whose `groups` ranges of them a
    column are summed in order; `cluster_wave` clusters the card holds at
    once. Needs the card."""
    info = (ctypes.c_longlong * len(PLAN_FIELDS))()
    bf16 = int(check_dtype(dtype) == torch.bfloat16)
    build.check(_entries()[1]["plan"](M, P, Q, bf16, info), "td_weight_grad_partials")
    return dict(zip(PLAN_FIELDS, info))


def colsum_partials(M: int, Q: int) -> int:
    """Partials of Q floats run_pass's column sums of M rows leave to
    reduce_kernel (csrc/pass_bwd.cuh colsum)."""
    return int(_entries()[1]["colsum"](M, Q))


REDUCE_GROUPS = 8  # csrc/weight_grad.cuh kRedGroups


def reduce_plain(partials):
    """out [n] = the sum over S of partials [S, n] in reduce_kernel's fixed
    order: REDUCE_GROUPS ranges [g S / G, (g + 1) S / G), each summed in
    ascending order from zero, the range sums added in range order."""
    S, out = partials.shape[0], None
    for g in range(REDUCE_GROUPS):
        r = torch.zeros_like(partials[0])
        for z in range(g * S // REDUCE_GROUPS, (g + 1) * S // REDUCE_GROUPS):
            r = r + partials[z]
        out = r if out is None else out + r
    return out


def reduce_partials(partials):
    """reduce_kernel alone (td_reduce_partials) on float32 partials [S, n],
    n a multiple of 4: the sum over S in its fixed order, on a CUDA tensor
    by the kernel (not counted in LAUNCHES), on a CPU tensor by
    `reduce_plain`. Not a path of the program: the reduction's check and
    its time beside torch.sum of the same partials (chip_smoke.py)."""
    if partials.dtype != torch.float32 or partials.dim() != 2 or partials.shape[1] % 4:
        raise ValueError("partials must be float32 [S, n] with n a multiple of 4, got "
                         f"{partials.dtype} {tuple(partials.shape)}")
    if partials.device.type == "cpu":
        return reduce_plain(partials)
    build.require_cuda(partials, "partials")
    partials = partials.contiguous()
    out = torch.empty(partials.shape[1], dtype=torch.float32, device=partials.device)
    build.check(_entries()[1]["reduce"](partials.data_ptr(), partials.shape[0],
                                        partials.shape[1], out.data_ptr(),
                                        build.stream_ptr(partials.device)),
                "td_reduce_partials")
    return out


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
    run_pass passes them); out [P, Q] contiguous and 16-byte aligned,
    allocated if None. Bases, row strides, P and Q must be multiples of 16
    bytes: the C entry refuses others."""
    build.require_cuda(X, "X")
    build.require_cuda(Y, "Y")
    ldx, ldy = _row_major(X, "X"), _row_major(Y, "Y")
    (M, P), Q = X.shape, Y.shape[1]
    if Y.shape[0] != M or Y.device != X.device:
        raise ValueError(f"X {tuple(X.shape)} and Y {tuple(Y.shape)} disagree on their rows "
                         "or device")
    if out is None:
        out = torch.empty((P, Q), dtype=torch.float32, device=X.device)
    elif (out.shape != (P, Q) or out.dtype != torch.float32 or not out.is_contiguous()
          or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous, 16-byte aligned float32 [{P}, {Q}] tensor")
    size, fns = _entries()
    partial = torch.empty(size(), dtype=torch.float32, device=X.device)
    build.check(fns[check_dtype(dtype)](X.data_ptr(), ldx, Y.data_ptr(), ldy, M, P, Q,
                                        out.data_ptr(), partial.data_ptr(),
                                        build.stream_ptr(X.device)), "td_weight_grad")
    (BF16_LAUNCHES if dtype == torch.bfloat16 else LAUNCHES)["alone"] += 1
    return out
