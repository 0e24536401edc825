"""Differentiable whole block: `block_layers_trainable` runs all L layers of
one UniTransformerO2 block with gradients to h, x, the edge weights and the
module's parameters. Replaces targetdiff_tpu/ops/pallas/block_vjp.py
(`block_layers_trainable`, its forward rule and the fused backward
`_block_bwd_kernel`).

For CUDA tensors, `_BlockLayers` (a torch.autograd.Function) runs the
train-mode forward of csrc/block_denoiser.cu, which writes per-layer
checkpoints, and its backward runs csrc/block_vjp.cu once over all layers. It
returns the gradients of h, x, e_w and of the packed weight stacks
(`pack_pass_params`); autograd carries those back through the packing into
the nn.Parameters. For CPU tensors the plain version runs: the eager
`block_forward` with the given e_w under ordinary autograd.

`dtype=torch.bfloat16` is the JAX package's bf16 training variant
(`get_diffusion_loss(impl='fast_bf16')`): the bf16 train-mode forward
(td_block_train_fwd_bf16) and the bf16 backward (td_block_bwd_bf16), every
dense product of both directions on bf16 operands with float32
accumulation. `_BlockLayers` takes the float32 stacks as its differentiable
inputs and makes the bf16 pack inside its forward, so the stacks'
gradients come back float32 (a bf16 pack outside would have autograd cast
every weight gradient to bf16). The CPU version is `block_forward(...,
dtype=torch.bfloat16)` under autograd (ops/precision.py Bf16Linear). The
kernels gather h and x natively: JAX's bf16 one-hot gathers and scatters and
its hi|lo position split are TPU encodings, so those stay float32 here.

`node_bwd_cuda` launches the backward's node kernel (csrc/node_bwd.cuh
node_bwd_kernel, once per pass in run_pass) alone on a pass's row buffer,
beside its plain version `node_bwd_plain`. `adjacency_cuda` builds the
backward's inverse adjacency (csrc/pass_bwd.cuh build_adjacency, a stable
counting sort in three kernels, once per pass and backward) alone, beside
its plain version `adjacency_plain`. `transposed_product_cuda` runs the
backward edge kernel's transposed second layers (da = d W2^T) alone, for
their time and their check against float64. `stage_w2` stages passes'
second layers as the backwards do (csrc/pass_bwd.cuh stage_w2_kernel, one
launch for every pass of a backward), beside their plain layouts
`stage_w2_frags` (float32) and `stage_w2_frags16` (bf16).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import graph as G
from ..precision import check_dtype, round_bf16
from ..rbf import FIXED_OFFSETS, gaussian_smearing_offsets
from . import build, weight_grad
from .block_denoiser import (_PassParams, _pass_structs, block_denoiser_train_cuda, cast_pack,
                             entry, pack_pass_params, require_pack)

LAUNCHES = 0  # float32 backward kernel runs since the last reset
NODE_BWD_LAUNCHES = 0  # node_bwd_kernel launches since the last reset (one per pass)
ADJ_LAUNCHES = 0  # inverse-adjacency builds (build_adjacency) since the last reset
# the bf16 backward's runs and its node_bwd_kernel's launches
BF16_LAUNCHES = BF16_NODE_BWD_LAUNCHES = 0
# stage_w2_kernel launches (float32, bf16) since the last reset: one a whole-block
# or per-layer backward
STAGE_W2_LAUNCHES = BF16_STAGE_W2_LAUNCHES = 0

FIELDS = [name for name, _ in _PassParams._fields_]
R = len(FIXED_OFFSETS)


class _PassGrads(ctypes.Structure):
    """Mirror of `PassGrads` in csrc/block_vjp.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "w_node", "b_node", "q_ln", "w_q2", "b_q2", "tab", "kv_ln", "w2k", "b2k", "w2v", "b2v")]


class _PassT(ctypes.Structure):
    """Mirror of `PassT` in csrc/pass_bwd.cuh (transposed weights)."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("w_nodeT", "w_q2T")]


def library_launch_counts() -> tuple:
    """(node_bwd_kernel launches, inverse-adjacency builds, bf16
    node_bwd_kernel launches, stage_w2_kernel launches, bf16 ones) the
    library has made in this process, as launch_node_bwd, build_adjacency
    and stage_w2 count them where they launch (td_node_bwd_launches,
    td_adj_builds, td_node_bwd_bf16_launches, td_stage_w2_launches)."""
    _, node, node16 = _node_bwd_entries()
    stage = _stage_w2_entries()[1]
    return node(), _adjacency_entries()[2](), node16(), stage(0), stage(1)


def count_library_launches(since: tuple) -> None:
    """Add the launches made since `library_launch_counts` read `since` to
    NODE_BWD_LAUNCHES, ADJ_LAUNCHES, BF16_NODE_BWD_LAUNCHES,
    STAGE_W2_LAUNCHES and BF16_STAGE_W2_LAUNCHES."""
    global NODE_BWD_LAUNCHES, ADJ_LAUNCHES, BF16_NODE_BWD_LAUNCHES
    global STAGE_W2_LAUNCHES, BF16_STAGE_W2_LAUNCHES
    node, adj, node16, stage, stage16 = np.subtract(library_launch_counts(), since).tolist()
    NODE_BWD_LAUNCHES += node
    ADJ_LAUNCHES += adj
    BF16_NODE_BWD_LAUNCHES += node16
    STAGE_W2_LAUNCHES += stage
    BF16_STAGE_W2_LAUNCHES += stage16


def row_layout(H: int, V: int) -> dict:
    """Columns of a pass's row buffer (csrc/pass_bwd.cuh, V = H for x2h, the
    heads for h2x): dproj [0, 5H) (the query MLP's dq1 at [4H, 5H)), dq at
    `dq`, the query LayerNorm's partials (dy * LN(q1), dy) at `qln`, `width`
    columns in all."""
    return {"dq": 10 * H + V, "qln": 11 * H + V, "width": 13 * H + V}


def node_bwd_plain(rowbuf, q1, dh, q_ln, w_q2T, w_nodeT, relu_mask=None, dtype=torch.float32):
    """node_bwd_kernel's function in plain PyTorch: from a pass's row buffer
    rowbuf [BN, W] (`row_layout`: dq and dproj[:, :4H]), the query MLP's
    first-layer output q1 [BN, H], its LayerNorm q_ln [2, H] and the
    transposed weights w_q2T [H, H], w_nodeT [5H, H], returns (rowbuf with
    dq1 and the LayerNorm partials written, qa = relu(LN(q1)) [BN, H],
    dh + dproj w_node^T). relu_mask, if given, stands for the ReLU's y > 0: a
    float64 reference takes the float32 version's (qa > 0), so that entries
    with y at zero's rounding distance do not flip. dtype=torch.bfloat16: the
    bf16 kernel's version, both products' operands rounded to bf16."""
    H = q1.shape[-1]
    r = round_bf16 if check_dtype(dtype) == torch.bfloat16 else (lambda t: t)
    lay = row_layout(H, rowbuf.shape[1] - 13 * H)
    mean = q1.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((q1 - mean) ** 2).mean(-1, keepdim=True) + 1e-5)
    zh = (q1 - mean) * rstd
    y = zh * q_ln[0] + q_ln[1]
    dy = (r(rowbuf[:, lay["dq"]:lay["dq"] + H]) @ r(w_q2T)) * (
        y > 0 if relu_mask is None else relu_mask)
    dzh = dy * q_ln[0]
    dq1 = rstd * (dzh - dzh.mean(-1, keepdim=True) - zh * (dzh * zh).mean(-1, keepdim=True))
    out = rowbuf.clone()
    out[:, 4 * H:5 * H] = dq1
    out[:, lay["qln"]:lay["qln"] + H] = dy * zh
    out[:, lay["qln"] + H:lay["qln"] + 2 * H] = dy
    return out, torch.relu(y), dh + r(out[:, :5 * H]) @ r(w_nodeT)


def node_bwd_cuda(rowbuf, q1, dh, q_ln, w_q2T, w_nodeT, qa=None, dtype=torch.float32):
    """node_bwd_kernel alone (td_node_bwd), as run_pass launches it, on the
    arguments of `node_bwd_plain`: writes dq1 and the LayerNorm partials into
    rowbuf and adds dproj w_node^T to dh, both in place, and returns (rowbuf,
    qa, dh), qa written into `qa` if given. Float32 contiguous CUDA tensors
    at the kernel's width H = 128, V = 128 (x2h) or 16 (h2x).
    dtype=torch.bfloat16 launches the bf16 instantiation (td_node_bwd_bf16,
    counted in BF16_NODE_BWD_LAUNCHES) on the same float32 arguments."""
    for name, t in (("rowbuf", rowbuf), ("q1", q1), ("dh", dh), ("q_ln", q_ln),
                    ("w_q2T", w_q2T), ("w_nodeT", w_nodeT)):
        build.require_cuda(t, name)
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != rowbuf.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on {rowbuf.device}")
    BN, W = rowbuf.shape
    H = 128
    lay = row_layout(H, W - 13 * H)
    if (W - 13 * H not in (H, 16) or q1.shape != (BN, H) or dh.shape != (BN, H)
            or q_ln.shape != (2, H) or w_q2T.shape != (H, H) or w_nodeT.shape != (5 * H, H)):
        raise ValueError(f"node_bwd takes rowbuf [BN, {14 * H}] or [BN, {13 * H + 16}], q1 and "
                         f"dh [BN, {H}], q_ln [2, {H}], w_q2T [{H}, {H}], w_nodeT [{5 * H}, {H}]")
    if qa is None:
        qa = torch.empty_like(q1)
    since = library_launch_counts()
    build.check(_node_bwd_entries()[0][check_dtype(dtype)][0](
        q1.data_ptr(), q_ln.data_ptr(), w_q2T.data_ptr(), w_nodeT.data_ptr(), BN, W, lay["dq"],
        lay["qln"], rowbuf.data_ptr(), qa.data_ptr(), dh.data_ptr(),
        build.stream_ptr(rowbuf.device)), entry("td_node_bwd", dtype))
    count_library_launches(since)
    return rowbuf, qa, dh


def node_bwd_info(rows: int, dtype=torch.float32) -> dict:
    """What the card makes of node_bwd_kernel of `dtype` for `rows` rows
    (td_node_bwd_info): its tile's rows, shared memory per block, blocks per
    SM, registers and local (spill) bytes per thread."""
    info = (ctypes.c_int * 5)()
    build.check(_node_bwd_entries()[0][check_dtype(dtype)][1](rows, info),
                entry("td_node_bwd_info", dtype))
    return dict(zip(("tile_rows", "smem", "blocks_per_sm", "registers", "local_bytes"), info))


@functools.lru_cache(maxsize=None)
def _node_bwd_entries():
    """({dtype: (td_node_bwd, td_node_bwd_info) of that instantiation},
    td_node_bwd_launches, td_node_bwd_bf16_launches)."""
    lib = build.load_library()
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for dtype in (torch.float32, torch.bfloat16):
        fn = getattr(lib, entry("td_node_bwd", dtype))
        fn.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
        info = getattr(lib, entry("td_node_bwd_info", dtype))
        info.argtypes = [i64, vp]
        info.restype = ctypes.c_int
        fns[dtype] = (fn, info)
    count, count16 = lib.td_node_bwd_launches, lib.td_node_bwd_bf16_launches
    count.argtypes, count.restype = [], i64
    count16.argtypes, count16.restype = [], i64
    return fns, count, count16


def adjacency_plain(idx, nmask, row0: int):
    """The inverse adjacency of the destination rows [row0, N) of idx [B, N,
    K] (int64) and nmask [B, N, K] (bool): (off [B, N+1], list [B, (N - row0)
    K]) int32. The valid edges, by pass-local id u = (i - row0) K + k, in a
    stable sort by source: source j's edges are list[b, off[b, j]:off[b, j+1]],
    ascending in u; off from a bincount's cumsum. The slots of list past
    off[b, N] hold -1 (the kernel leaves them unwritten)."""
    B, N, K = idx.shape
    src = idx[:, row0:].reshape(B, -1)
    valid = nmask[:, row0:].reshape(B, -1)
    key = torch.where(valid, src, N)  # invalid edges sort last
    order = torch.sort(key, dim=-1, stable=True).indices
    lst = torch.where(torch.gather(valid, 1, order), order, -1).to(torch.int32)
    bins = key + (N + 1) * torch.arange(B, device=idx.device)[:, None]
    counts = torch.bincount(bins.flatten(), minlength=B * (N + 1)).view(B, N + 1)[:, :N]
    off = torch.cat([counts.new_zeros(B, 1), counts.cumsum(-1)], -1).to(torch.int32)
    return off, lst


def adjacency_cuda(idx, nmask, row0: int):
    """build_adjacency alone (td_adjacency), as the backwards run it, on the
    arguments of `adjacency_plain`: (off, list), list's slots past off[b, N]
    unwritten. CUDA tensors, N <= edge_layer_vjp.MAX_NODES."""
    global ADJ_LAUNCHES
    build.require_cuda(idx, "idx")
    B, N, K = idx.shape
    if (idx.dtype != torch.int64 or nmask.dtype != torch.bool or nmask.shape != idx.shape
            or nmask.device != idx.device):
        raise ValueError("idx must be int64 [B, N, K] and nmask bool of the same shape and device")
    if not 0 <= row0 < N:
        raise ValueError(f"row0={row0} must lie in [0, N={N})")
    idx, nmask = idx.contiguous(), nmask.contiguous()
    fn, scratch, count = _adjacency_entries()
    E = (N - row0) * K
    off = torch.empty((B, N + 1), dtype=torch.int32, device=idx.device)
    lst = torch.empty(B * E + scratch(B, N, K, row0), dtype=torch.int32, device=idx.device)
    before = count()
    build.check(fn(idx.data_ptr(), nmask.data_ptr(), B, N, K, row0, off.data_ptr(),
                   lst.data_ptr(), build.stream_ptr(idx.device)), "td_adjacency")
    ADJ_LAUNCHES += count() - before
    return off, lst[:B * E].view(B, E)


@functools.lru_cache(maxsize=None)
def _adjacency_entries():
    lib = build.load_library()
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.td_adjacency
    fn.argtypes = [vp, vp, i32, i32, i32, i32, vp, vp, vp]
    fn.restype = ctypes.c_int
    scratch = lib.td_adjacency_scratch_ints
    scratch.argtypes, scratch.restype = [i32, i32, i32, i32], i64
    count = lib.td_adj_builds
    count.argtypes, count.restype = [], i64
    return fn, scratch, count


def edge_bwd_info(K: int, h2x: bool, dtype=torch.float32) -> dict:
    """What the card makes of the backward's edge kernel of `dtype`
    (csrc/pass_bwd.cuh edge_bwd_kernel) for one pass of K neighbours
    (td_edge_bwd_info, td_edge_bwd_info_bf16): its shared memory per block,
    blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers
    and local (spill) bytes per thread."""
    info = (ctypes.c_int * 4)()
    name = entry("td_edge_bwd_info", dtype)
    build.check(_info_entry(name)(int(h2x), K, info), name)
    return dict(zip(("smem", "blocks_per_sm", "registers", "local_bytes"), info))


@functools.lru_cache(maxsize=None)
def _info_entry(name: str):
    fn = getattr(build.load_library(), name)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.load_library()
    vp, i32, f32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    ws = lib.td_block_bwd_workspace
    ws.argtypes = [i32, i32, i32, i32, i32, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    ws.restype = None
    bwd = {}
    for dtype in (torch.float32, torch.bfloat16):
        fn = getattr(lib, entry("td_block_bwd", dtype))
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, f32,
                       ctypes.POINTER(_PassParams), ctypes.POINTER(_PassParams),
                       ctypes.POINTER(_PassT), ctypes.POINTER(_PassT),
                       ctypes.POINTER(_PassGrads), ctypes.POINTER(_PassGrads),
                       i32, i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, i64, vp, i64, vp]
        fn.restype = ctypes.c_int
        bwd[dtype] = fn
    return ws, bwd


def tf32(a):
    """a (float32) rounded to TF32 as the kernels round it (csrc/weight_grad.cuh
    rna_tf32): to nearest, ties away from zero, on the 13 low mantissa bits."""
    return ((a.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def stage_rbf_frags(w_rbf):
    """The d rbf product's B fragments as run_pass stages them for
    edge_bwd_kernel (csrc/pass_bwd.cuh stage_rbf_kernel) from one pass's
    w_rbf [4, R, 2H] float32: int32 TF32 bit patterns [2, 2H/8, 2R/8, 32, 4]
    by destination kind ta (0 ligand row, 1 protein row), k-step ks, n-tile
    nt, lane 4 g + tig and (b0 hi, b1 hi, b0 lo, b1 lo), where
    B[k][j] = w_rbf[ta if j < R else ta + 2][j % R][k], b0 = B[8 ks + tig][8 nt + g],
    b1 = B[8 ks + tig + 4][8 nt + g], hi = tf32(b), lo = tf32(b - hi). A CUDA
    tensor goes through the staging kernel (td_stage_rbf), a CPU tensor
    through the same layout in PyTorch."""
    H2 = w_rbf.shape[-1]
    if w_rbf.dtype != torch.float32 or w_rbf.shape != (4, R, H2) or H2 % 8:
        raise ValueError(f"w_rbf must be a float32 [4, {R}, 2H] tensor, got {w_rbf.dtype} "
                         f"{tuple(w_rbf.shape)}")
    shape = (2, H2 // 8, 2 * R // 8, 32, 4)
    if w_rbf.device.type == "cpu":
        b = torch.stack([torch.cat([w_rbf[ta], w_rbf[ta + 2]]).T for ta in (0, 1)])
        b = b.reshape(2, H2 // 8, 2, 4, 2 * R // 8, 8)  # kind, ks, b0|b1, tig, nt, g
        hi = tf32(b)
        lo = tf32(b - hi)
        frags = torch.cat([t.permute(0, 1, 4, 5, 3, 2) for t in (hi, lo)], -1)
        return frags.reshape(shape).contiguous().view(torch.int32)
    build.require_cuda(w_rbf, "w_rbf")
    if H2 != 256:
        raise ValueError(f"the kernel's tables are [4, {R}, 256], got {tuple(w_rbf.shape)}")
    w_rbf = w_rbf.contiguous()
    out = torch.empty(shape, dtype=torch.int32, device=w_rbf.device)
    build.check(_stage_entry()(w_rbf.data_ptr(), out.data_ptr(), build.stream_ptr(w_rbf.device)),
                "td_stage_rbf")
    return out


@functools.lru_cache(maxsize=None)
def _stage_entry():
    fn = build.load_library().td_stage_rbf
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def frags16(B, scale=1.0):
    """A [16 ks, 8 nt] B operand (rows k, columns n; float32 holding bf16
    values) as csrc/pass_bwd.cuh stage_frags16 stages it: int32 [ks, nt, 32,
    2] by k-step, n-tile, lane 4 g + tig and (b0, b1), each word the bf16
    pair (B[16 ks + 2 tig][8 nt + g], B[16 ks + 2 tig + 1][..]) times scale,
    the lower k in the low half; b1 the same 8 rows down."""
    K, N = B.shape
    # ks, b0|b1, tig, k % 2, nt, g
    b = round_bf16(B.float() * scale).reshape(K // 16, 2, 4, 2, N // 8, 8)
    bits = b.contiguous().view(torch.int32) >> 16 & 0xFFFF  # the bf16 bit patterns
    words = bits[:, :, :, 0] | bits[:, :, :, 1] << 16  # ks, b0|b1, tig, nt, g
    return words.permute(0, 3, 4, 2, 1).reshape(K // 16, N // 8, 32, 2).contiguous()


def stage_w2_frags16(w2k, w2v):
    """The fragments stage_w2_kernel<true> stages for edge_bwd_kernel from
    one pass's bf16 second layers w2k [H][H] and w2v [H][V]: int32 (b0, b1)
    words of, in order, w2k and w2v times 2^8 (the recompute's second layers,
    B = W) and their transposes (the transposed product, B[c][m] = W[m][c]),
    each flattened as `frags16`, each at the start of its region of
    `W2_REGION_WORDS` // 2 words (4096 (b0, b1) pairs). CPU tensors only: the
    layout the kernel reads, for the tests."""
    w2k, w2v = w2k.float(), w2v.float()
    return [frags16(w, s).reshape(-1, 2) for w, s in ((w2k, 256.0), (w2v, 256.0),
                                                       (w2k.T, 1.0), (w2v.T, 1.0))]


# int32 words of one staged pass (csrc/pass_bwd.cuh kW2Staged uint4) and of
# each of its four regions (kW2Frags uint4)
W2_STAGED_WORDS = 4 * 4 * 4096
W2_REGION_WORDS = 4 * 4096


def split_f16(x):
    """x = hi + lo, each rounded to fp16 to nearest even (tc_common.cuh
    split_f16): int32 bit patterns (hi, lo) of the halves."""
    hi = x.half()
    lo = (x - hi.float()).half()
    return (hi.view(torch.int16).int() & 0xFFFF), (lo.view(torch.int16).int() & 0xFFFF)


def stage_w2_frags(w2k, w2v):
    """The words stage_w2_kernel<false> stages for edge_bwd_kernel from one
    pass's float32 second layers w2k [H][H] and w2v [H][V], as one int32
    tensor of `W2_STAGED_WORDS`: at word 0 and at W2_REGION_WORDS, w2k and w2v
    times 2^8 as (b0 hi, b1 hi, b0 lo, b1 lo) words [H/16 ks, n/8 nt, 32 lane,
    4] (tc_common.cuh stage_frags: b0 the fp16 pair of rows 16 ks + 2 tig and
    + 1 of column 8 nt + g, b1 those 8 rows down, hi and lo its split_f16
    halves); from 2 W2_REGION_WORDS the float32 bits of w2k^T [H][H], then
    w2v^T [V][H]. Words the kernel does not write (after w2v's fragments when
    V < H) are 0. The plain version of the staging (tests, chip_smoke.py),
    on the weights' device."""
    H, V = w2v.shape
    out = torch.zeros(W2_STAGED_WORDS, dtype=torch.int32, device=w2k.device)
    for i, w in enumerate((w2k.float(), w2v.float())):
        n = w.shape[1]
        hi, lo = split_f16(256.0 * w)
        pairs = []
        for half in (hi, lo):
            # ks, b0|b1, tig, k % 2, nt, g -> the pair's lower k in the low half
            b = half.reshape(H // 16, 2, 4, 2, n // 8, 8)
            pairs.append(b[:, :, :, 0] | b[:, :, :, 1] << 16)  # ks, b0|b1, tig, nt, g
        words = torch.stack(pairs, 1).reshape(H // 16, 4, 4, n // 8, 8)  # ks, (hi|lo, b0|b1)
        words = words.permute(0, 3, 4, 2, 1)  # ks, nt, g, tig, (hi b0, hi b1, lo b0, lo b1)
        words = words.reshape(H // 16, n // 8, 32, 4)
        out[i * W2_REGION_WORDS:i * W2_REGION_WORDS + words.numel()] = words.reshape(-1)
    wt = torch.cat([w2k.float().T, w2v.float().T]).contiguous().view(torch.int32).reshape(-1)
    out[2 * W2_REGION_WORDS:2 * W2_REGION_WORDS + wt.numel()] = wt
    return out


def pass_words(w2k, w2v, dtype=torch.float32):
    """One pass's staged words (int32 [W2_STAGED_WORDS], on the weights'
    device) for a pack of `dtype`: `stage_w2_frags`, or `stage_w2_frags16`'s
    four regions at word i W2_REGION_WORDS // 2, zeros where the kernel
    writes nothing."""
    if check_dtype(dtype) == torch.float32:
        return stage_w2_frags(w2k, w2v)
    out = torch.zeros(W2_STAGED_WORDS, dtype=torch.int32, device=w2k.device)
    for i, words in enumerate(stage_w2_frags16(w2k, w2v)):
        out[i * W2_REGION_WORDS // 2:i * W2_REGION_WORDS // 2 + words.numel()] = words.reshape(-1)
    return out


def stage_w2(w2k, w2v, dtype=torch.float32, frags=None):
    """Stages the second layers of len(w2k) passes, w2k[i] [H, H] and w2v[i]
    [H, V] (V = 128 or 16) of a pack of `dtype`, as a backward stages its
    passes: CUDA tensors in one stage_w2_kernel launch (td_stage_w2;
    kMaxStagePasses = 64 passes a launch), CPU tensors through the plain
    layouts (`pass_words`). Returns int32 [passes, W2_STAGED_WORDS], pass i
    at row i; frags, if given (CUDA), receives them (zero it where words the
    kernel does not write matter). Not a path of the program: the staging's
    check and its time (tests, chip_smoke.py)."""
    if len(w2k) != len(w2v) or not w2k:
        raise ValueError("give one w2k and one w2v a pass")
    for i, (k, v) in enumerate(zip(w2k, w2v)):
        require_pack(k.dtype, dtype, "the second layers")
        if (k.shape != (128, 128) or v.shape[0] != 128 or v.shape[1] not in (128, 16)
                or v.dtype != k.dtype or k.device != v.device):
            raise ValueError(f"pass {i}: w2k must be [128, 128] and w2v [128, 128|16], of one "
                             "dtype and device")
    dev, n = w2k[0].device, len(w2k)
    if dev.type == "cpu":
        return torch.stack([pass_words(k, v, dtype) for k, v in zip(w2k, w2v)])
    for k, v in zip(w2k, w2v):
        build.require_cuda(k, "w2k")
        build.require_cuda(v, "w2v")
        if not (k.is_contiguous() and v.is_contiguous()) or (k.data_ptr() | v.data_ptr()) % 16:
            raise ValueError("the second layers must be contiguous and 16-byte aligned")
    if frags is None:
        frags = torch.zeros((n, W2_STAGED_WORDS), dtype=torch.int32, device=dev)
    elif frags.shape != (n, W2_STAGED_WORDS) or frags.dtype != torch.int32 \
            or not frags.is_contiguous() or frags.data_ptr() % 16:
        raise ValueError(f"frags must be a contiguous int32 [{n}, {W2_STAGED_WORDS}] tensor")
    arr = ctypes.c_void_p * n
    since = library_launch_counts()
    build.check(_stage_w2_entries()[0](
        arr(*[k.data_ptr() for k in w2k]), arr(*[v.data_ptr() for v in w2v]),
        (ctypes.c_int * n)(*[v.shape[1] for v in w2v]), n, int(dtype == torch.bfloat16),
        frags.data_ptr(), build.stream_ptr(dev)), "td_stage_w2")
    count_library_launches(since)
    return frags


@functools.lru_cache(maxsize=None)
def _stage_w2_entries():
    lib = build.load_library()
    vp = ctypes.c_void_p
    fn = lib.td_stage_w2
    fn.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int, vp, vp]
    fn.restype = ctypes.c_int
    count = lib.td_stage_w2_launches
    count.argtypes, count.restype = [ctypes.c_int], ctypes.c_longlong
    return fn, count


def transposed_product_cuda(d, w2k, w2v, dtype=torch.float32, frags=None):
    """The backward's transposed second layers alone on the card: tprod_kernel
    (csrc/pass_bwd.cuh), one block a 32-edge chunk running transposed_layers
    as edge_bwd_kernel runs it, after stage_w2_kernel (td_tprod,
    td_tprod_bf16). d [E, H + V] float32, w2k [H, H] and w2v [H, V] of a
    pack of `dtype` (H = 128, V = 128 or 16). frags, if given, a CUDA
    buffer of td_tprod_frag_bytes() bytes that receives the staged
    fragments. Not a path of the program: its time and its check against
    float64 (chip_smoke.py, tests/test_torch_cuda.py). Returns [E, 2H]
    float32."""
    H, V = w2v.shape
    for name, t in (("d", d), ("w2k", w2k), ("w2v", w2v)):
        build.require_cuda(t, name)
    require_pack(w2k.dtype, dtype, "the second layers")
    if d.dtype != torch.float32 or d.dim() != 2 or d.shape[1] != H + V or H != 128 \
            or V not in (128, 16) or w2k.shape != (H, H) or w2v.dtype != w2k.dtype:
        raise ValueError(f"d must be float32 [E, {H} + V] and w2k [128, 128], w2v [128, 128|16] "
                         f"of one dtype, got {tuple(d.shape)}, {tuple(w2k.shape)}, "
                         f"{tuple(w2v.shape)}")
    fn, size = _tprod_entries()
    if frags is None:
        frags = torch.empty(size() // 4, dtype=torch.int32, device=d.device)
    elif frags.numel() * frags.element_size() < size() or frags.data_ptr() % 16:
        raise ValueError("frags must be a 16-byte aligned buffer of td_tprod_frag_bytes() bytes")
    d, w2k, w2v = d.contiguous(), w2k.contiguous(), w2v.contiguous()
    da = torch.empty((d.shape[0], 2 * H), dtype=torch.float32, device=d.device)
    name = entry("td_tprod", dtype)
    build.check(fn[check_dtype(dtype)](
        d.data_ptr(), d.shape[0], int(V != H), w2k.data_ptr(), w2v.data_ptr(), da.data_ptr(),
        frags.data_ptr(), build.stream_ptr(d.device)), name)
    return da


@functools.lru_cache(maxsize=None)
def _tprod_entries():
    lib = build.load_library()
    vp = ctypes.c_void_p
    fns = {}
    for dtype in (torch.float32, torch.bfloat16):
        fn = getattr(lib, entry("td_tprod", dtype))
        fn.argtypes = [vp, ctypes.c_longlong, ctypes.c_int, vp, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    size = lib.td_tprod_frag_bytes
    size.argtypes, size.restype = [], ctypes.c_longlong
    return fns, size


def block_layers_trainable(refine_net, h, x, nbh: G.Neighborhood, mask_ligand, e_w,
                           n_ligand: int, dtype=torch.float32):
    """All layers of one block, differentiable. h [B,N,H], x [B,N,3], e_w
    [B,N,K] (the global edge weights, computed by the caller), ligand rows
    the last `n_ligand` of N. dtype: the products' precision in both
    directions, torch.float32 or torch.bfloat16 (h, x and every gradient
    stay float32). Returns (h, x) after the block."""
    check_dtype(dtype)
    if h.device.type == "cpu":
        return refine_net.block_forward(h, x, nbh, mask_ligand, e_w=e_w, dtype=dtype)
    x2h, h2x = pack_pass_params(refine_net)
    return _BlockLayers.apply(h, x, e_w, nbh.idx, nbh.mask, mask_ligand, refine_net, n_ligand,
                              dtype, *[x2h[f] for f in FIELDS], *[h2x[f] for f in FIELDS])


class _BlockLayers(torch.autograd.Function):
    """The block on the kernels of `dtype`; its differentiable inputs are the
    float32 stacks, the kernels' pack (`cast_pack`) is made here."""

    @staticmethod
    def forward(ctx, h, x, e_w, idx, nmask, mlig, refine_net, n_ligand, dtype, *flat):
        n = len(FIELDS)
        x2h = cast_pack(dict(zip(FIELDS, flat[:n])), dtype)
        h2x = cast_pack(dict(zip(FIELDS, flat[n:])), dtype)
        hck, xck = block_denoiser_train_cuda(refine_net, h, x, G.Neighborhood(idx, nmask), mlig,
                                             e_w, n_ligand, x2h, h2x, dtype)
        ctx.save_for_backward(hck, xck, e_w, idx, nmask, mlig, *[x2h[f] for f in FIELDS],
                              *[h2x[f] for f in FIELDS])
        ctx.n_ligand, ctx.dtype = n_ligand, dtype
        return hck[-1].clone(), xck[-1].clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, gh, gx):
        hck, xck, e_w, idx, nmask, mlig, *flat = ctx.saved_tensors
        n = len(FIELDS)
        x2h, h2x = dict(zip(FIELDS, flat[:n])), dict(zip(FIELDS, flat[n:]))
        dh0, dx0, dew, gx2h, gh2x = block_bwd_cuda(hck, xck, idx, nmask, mlig, e_w, ctx.n_ligand,
                                                   x2h, h2x, gh, gx, ctx.dtype)
        return (dh0, dx0, dew, None, None, None, None, None, None,
                *[gx2h[f] for f in FIELDS], *[gh2x[f] for f in FIELDS])


def _grad_stacks(stacks: dict):
    """Float32 gradient tensors shaped like one pass's stacks (of either
    dtype); w_rbf and w_et are views of one [L, 4R+4, 2H] table, as the
    kernel writes them."""
    L, H2 = stacks["w_et"].shape[0], stacks["w_et"].shape[-1]
    g = {f: torch.empty_like(stacks[f], dtype=torch.float32,
                             memory_format=torch.contiguous_format) for f in FIELDS}
    tab = torch.empty((L, 4 * R + 4, H2), dtype=torch.float32, device=stacks["w_et"].device)
    g["w_rbf"] = tab[:, :4 * R].reshape(stacks["w_rbf"].shape)
    g["w_et"] = tab[:, 4 * R:]
    g["tab"] = tab
    return g


def _grad_structs(g: dict, L: int):
    return [_PassGrads(*[g[name][l].data_ptr() for name, _ in _PassGrads._fields_])
            for l in range(L)]


def _transposed(stacks: dict):
    """The node kernel's backward products' transposed weights, float32 (a
    bf16 pack's exactly: its kernel rounds them where it reads them)."""
    return {name: stacks[src].detach().transpose(1, 2).float().contiguous()
            for name, src in (("w_nodeT", "w_node"), ("w_q2T", "w_q2"))}


def block_bwd_cuda(hck, xck, idx, nmask, mlig, e_w, n_ligand, x2h, h2x, gh, gx,
                   dtype=torch.float32):
    """The backward kernel of `dtype`. hck [L+1,B,N,H] and xck [L+1,B,N,3]
    are the train-mode checkpoints, gh [B,N,H] / gx [B,N,3] the output
    cotangents, x2h / h2x the stacks packed for `dtype` (as the train-mode
    forward took them). Returns (dh0, dx0, de_w, x2h grads, h2x grads), every
    one float32."""
    global LAUNCHES, BF16_LAUNCHES
    L1, B, N, H = hck.shape
    L, K = L1 - 1, idx.shape[-1]
    dev = hck.device
    for name, t in (("hck", hck), ("xck", xck), ("idx", idx), ("nbr_mask", nmask),
                    ("mask_ligand", mlig), ("e_w", e_w)):
        build.require_cuda(t, name)
    hck, xck = hck.contiguous(), xck.contiguous()
    if xck.shape != (L1, B, N, 3) or e_w.shape != (B, N, K) or idx.shape != (B, N, K):
        raise ValueError("checkpoints, e_w and idx disagree on their shapes")
    require_pack(x2h["w_node"].dtype, dtype, "the backward's weights")
    require_pack(h2x["w_node"].dtype, dtype, "the backward's weights")
    gh, gx = gh.float().contiguous(), gx.float().contiguous()
    ws_size, bwd = _entries()
    nf, ni = ctypes.c_longlong(), ctypes.c_longlong()
    ws_size(B, N, K, n_ligand, 2 * L, ctypes.byref(nf), ctypes.byref(ni))
    work = torch.empty(nf.value, dtype=torch.float32, device=dev)
    iwork = torch.empty(ni.value, dtype=torch.int32, device=dev)
    offsets, coeff = gaussian_smearing_offsets(device=dev)
    gx2h, gh2x = _grad_stacks(x2h), _grad_stacks(h2x)
    tx2h, th2x = _transposed(x2h), _transposed(h2x)
    arr = lambda cls, items: (cls * L)(*items)  # noqa: E731
    dh0 = torch.empty((B, N, H), dtype=torch.float32, device=dev)
    dx0 = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    dew = torch.empty((B, N, K), dtype=torch.float32, device=dev)
    ewc, idxc, nmc, mlc = e_w.contiguous(), idx.contiguous(), nmask.contiguous(), mlig.contiguous()
    since = library_launch_counts()
    name = entry("td_block_bwd", dtype)
    build.check(bwd[dtype](
        hck.data_ptr(), xck.data_ptr(), idxc.data_ptr(), nmc.data_ptr(), mlc.data_ptr(),
        ewc.data_ptr(), offsets.data_ptr(), coeff,
        arr(_PassParams, _pass_structs(x2h, L)), arr(_PassParams, _pass_structs(h2x, L)),
        arr(_PassT, [_PassT(*[tx2h[f][l].data_ptr() for f, _ in _PassT._fields_])
                     for l in range(L)]),
        arr(_PassT, [_PassT(*[th2x[f][l].data_ptr() for f, _ in _PassT._fields_])
                     for l in range(L)]),
        arr(_PassGrads, _grad_structs(gx2h, L)), arr(_PassGrads, _grad_structs(gh2x, L)),
        L, B, N, K, n_ligand, gh.data_ptr(), gx.data_ptr(), dh0.data_ptr(), dx0.data_ptr(),
        dew.data_ptr(), work.data_ptr(), nf.value, iwork.data_ptr(), ni.value,
        build.stream_ptr(dev)), name)
    if dtype == torch.bfloat16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    weight_grad.count_passes("x2h", L, dtype)
    weight_grad.count_passes("h2x", L, dtype)
    count_library_launches(since)
    return dh0, dx0, dew, gx2h, gh2x
