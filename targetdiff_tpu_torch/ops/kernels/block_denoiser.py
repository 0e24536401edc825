"""Whole-block denoiser: the CUDA kernels of csrc/block_denoiser.cu for CUDA
tensors, the eager `UniTransformerO2TwoUpdateGeneral.block_forward` for CPU
tensors. Replaces targetdiff_tpu/ops/pallas/block_denoiser.py
(`block_denoiser`) in inference mode (`block_denoiser`: every row live, or
with a `cone.Cone` the rows of the sampler's dependency cone, JAX's
need_full_h=False with per-layer tile flags at row granularity) and
in train mode (`block_denoiser_train_cuda`: edge weights given, per-layer
checkpoints of h and x returned for the backward of ops/kernels/block_vjp.py;
its plain version is `block_denoiser_train_plain`).

The CUDA path runs one edge-weight kernel per block and, per layer, a node
kernel + x2h edge kernel, then a node kernel (the protein rows' source
projections only) + h2x edge kernel on the ligand rows. With fix_x (the
embedding export) the positions stay as given, so the h2x pass, whose only
output is x, is not launched at all.
With a cone (ops/kernels/cone.py) layer l's node launch covers the rows of
hop <= L - l + 1 (nj; ni and q on hop <= L - l), its x2h launch the rows of
hop <= L - l, and the h2x pass's node launch the ligand rows (ni, q) and
hop <= 1 (nj), each through the row list `cone.order` and the device
counts `cone.counts` (the `*_list` entry points); the rows outside a
layer's set are not written, so the protein rows of the returned h are
stale. Both ping-pong buffers start as copies of h: nothing uninitialised
leaves the block. The plain version (`block_forward(..., cone=...)`)
computes the same rows.
`node_projections_cuda` launches the node kernel alone (the card tests'
launcher), beside its plain version; `edge_weights_cuda` the edge-weight
kernel alone, whose plain version is the module's `edge_weights`. Its weights come from `pack_block_params`, which regroups the
module's Linear weights as [in, out] blocks: the destination (h_i) and
source (h_j) parts of each edge MLP's first layer become per-node
projections, and its edge-feature part becomes one [4, R, 2H] table indexed
by edge type (the outer product rbf x onehot(type) picks one R-row block).
The packing is differentiable: gradients of the packed stacks reach the
module's parameters through autograd's cat/transpose/stack backward.

Precision: `dtype=torch.bfloat16` (the sampling path's default, as the JAX
package's dtype=bf16) launches the bf16 instantiations of the same kernels
(the `*_bf16` entry points: one bf16 tensor-core product with float32
accumulation per product). Their product weights are packed as bf16 tensors
(`pack_block_params(..., dtype)`; biases and LayerNorm stay float32), and
the stacks' dtype says which kernels a pack is for. Their plain version is
the module's `block_forward(..., dtype=torch.bfloat16)`. bf16 launches are
counted apart (the `BF16_*` counts). The train mode has a bf16 entry too
(`block_denoiser_train_cuda(..., dtype=torch.bfloat16)`, the forward of the
bf16 training variant): its checkpoints stay float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import graph as G
from ..precision import check_dtype, round_bf16
from ..rbf import gaussian_smearing_offsets
from . import build

LAUNCHES = 0  # block_denoiser calls that launched the kernels since the last reset
TRAIN_LAUNCHES = 0  # float32 block_denoiser_train_cuda launches since the last reset
BF16_TRAIN_LAUNCHES = 0  # the same of the bf16 train-mode entry
EW_LAUNCHES = 0  # edge-weight kernel launches since the last reset
X2H_PASS_LAUNCHES = 0  # block_denoiser_cuda's x2h edge launches since the last reset
H2X_PASS_LAUNCHES = 0  # block_denoiser_cuda's h2x edge launches since the last reset
# the same four counts of the bf16 kernels (dtype=torch.bfloat16); the counts
# above are float32 launches only
BF16_LAUNCHES = BF16_EW_LAUNCHES = BF16_X2H_PASS_LAUNCHES = BF16_H2X_PASS_LAUNCHES = 0

# the kernels are specialised to the released architecture's widths
HIDDEN, HEADS, MAX_K = 128, 16, 32


class PackedBlock(NamedTuple):
    """Kernel weights of one refine_net, contiguous: the product weights in
    `dtype`, the rest float32.
    ew: (w1 [R,H], b1 [H], ln [2,H], w2 [H], b2 [1]).
    x2h / h2x: dicts of [L, ...] stacks (see `_pack_pass`)."""

    ew: tuple
    x2h: dict
    h2x: dict

    @property
    def dtype(self) -> torch.dtype:
        """The precision of the kernels the pack is for."""
        return self.x2h["w_node"].dtype


# the stacks that are product weights: packed in the kernels' dtype
WEIGHT_FIELDS = ("w_node", "w_q2", "w_rbf", "w_et", "w2k", "w2v")


class _PassParams(ctypes.Structure):
    """Mirror of `PassParams` in csrc/block_denoiser.cu (one layer, one pass)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "w_node", "b_node", "q_ln", "w_q2", "b_q2", "w_rbf", "w_et", "kv_ln",
        "w2k", "b2k", "w2v", "b2v")]


class _EwParams(ctypes.Structure):
    """Mirror of `EwParams` in csrc/block_denoiser.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("w1", "b1", "ln", "w2", "b2")]


def _pack_pass(layers, prefix: str, dtype=torch.float32) -> dict:
    """Stack one pass (prefix 'h' = x2h, 'x' = h2x) over layers, the
    WEIGHT_FIELDS in `dtype` and the rest float32. The first
    Linear of each edge MLP takes [edge type (4) | rbf x type (4R) | h_i | h_j]:
      w_node [H, 5H]  columns [k.h_i | v.h_i | k.h_j | v.h_j | q first layer]
      b_node [5H]     [k bias | v bias | 0 | 0 | q bias]
      w_rbf [4, R, 2H], w_et [4, 2H]  edge-feature rows of k|v per edge type
      kv_ln [2, 2H]   LayerNorm scale and bias of k|v
      q_ln [2, H], w_q2 [H, H], b_q2 [H]  rest of the query MLP
      w2k [H, H], b2k [H], w2v [H, V], b2v [V]  second layers (V = H or heads)
    """
    check_dtype(dtype)
    out = {name: [] for name, _ in _PassParams._fields_}
    for layer in layers:
        att = layer.x2h_layers[0] if prefix == "h" else layer.h2x_layers[0]
        mk = getattr(att, f"{prefix}k_func").net
        mv = getattr(att, f"{prefix}v_func").net
        mq = getattr(att, f"{prefix}q_func").net
        H = mq[0].weight.shape[0]
        w1k, w1v = mk[0].weight, mv[0].weight  # [H, 4 + 4R + 2H]
        E, RF = 4, w1k.shape[1] - 4 - 2 * H
        hi, hj = slice(E + RF, E + RF + H), slice(E + RF + H, E + RF + 2 * H)
        out["w_node"].append(torch.cat([w1k[:, hi].t(), w1v[:, hi].t(), w1k[:, hj].t(),
                                        w1v[:, hj].t(), mq[0].weight.t()], dim=1))
        out["b_node"].append(torch.cat([mk[0].bias, mv[0].bias, mk[0].bias.new_zeros(2 * H),
                                        mq[0].bias]))
        out["q_ln"].append(torch.stack([mq[1].weight, mq[1].bias]))
        out["w_q2"].append(mq[3].weight.t())
        out["b_q2"].append(mq[3].bias)
        w_rf = torch.cat([w1k[:, E:E + RF], w1v[:, E:E + RF]], dim=0)  # [2H, 4R], a-major
        out["w_rbf"].append(w_rf.reshape(2 * H, E, RF // E).permute(1, 2, 0))
        out["w_et"].append(torch.cat([w1k[:, :E], w1v[:, :E]], dim=0).t())
        out["kv_ln"].append(torch.stack([torch.cat([mk[1].weight, mv[1].weight]),
                                         torch.cat([mk[1].bias, mv[1].bias])]))
        out["w2k"].append(mk[3].weight.t())
        out["b2k"].append(mk[3].bias)
        out["w2v"].append(mv[3].weight.t())
        out["b2v"].append(mv[3].bias)
    return cast_pack({k: torch.stack(v).contiguous() for k, v in out.items()}, dtype)


def cast_pack(stacks: dict, dtype) -> dict:
    """One pass's stacks for the kernels of `dtype`: the WEIGHT_FIELDS in
    `dtype`, the rest float32."""
    check_dtype(dtype)
    return {k: v.to(dtype if k in WEIGHT_FIELDS else torch.float32) for k, v in stacks.items()}


FIRST_LAYER_DEPTH = 96  # [edge type (4) | type x RBF (4 R = 80)], zero rows to 16-deep k-steps


def pack_first_layer_table(stacks, layer: int = 0):
    """The edge-feature part of one pass's k|v first layers as one table
    [FIRST_LAYER_DEPTH, 2H], as the bf16 x2h kernel stages it in shared
    memory from w_et and w_rbf (csrc/x2h_edge_bf16.cuh stage_x2h_tables):
    row k < 4 is w_et[k], row 4 + R t + r is w_rbf[t][r] (the reference's
    r_feat order, type-major), then zero rows. A slot's row [one-hot type t |
    type x RBF | 0] times it gives w_et[t] + sum_r rbf_r w_rbf[t][r]."""
    w_et, w_rbf = stacks["w_et"][layer], stacks["w_rbf"][layer]
    E, R, C = w_rbf.shape
    pad = w_et.new_zeros((FIRST_LAYER_DEPTH - E - E * R, C))
    return torch.cat([w_et, w_rbf.reshape(E * R, C), pad])


def pack_pass_params(refine_net, dtype=torch.float32):
    """(x2h, h2x) stacks of a UniTransformerO2TwoUpdateGeneral's layers, as
    `_pack_pass` lays them out; differentiable."""
    return (_pack_pass(refine_net.base_block, "h", dtype),
            _pack_pass(refine_net.base_block, "x", dtype))


def pack_block_params(refine_net, dtype=torch.float32) -> PackedBlock:
    """Regroup a UniTransformerO2TwoUpdateGeneral's weights for the kernels
    of `dtype` (counterpart of targetdiff_tpu/models/fast_forward.py:
    extract_block_params, whose product weights are in its dtype too);
    differentiable, so callers that only infer run it under no_grad."""
    check_dtype(dtype)
    ep = refine_net.edge_pred_layer.net
    ew = (ep[0].weight.t().to(dtype).contiguous(), ep[0].bias.float().contiguous(),
          torch.stack([ep[1].weight, ep[1].bias]).float().contiguous(),
          ep[3].weight.reshape(-1).to(dtype).contiguous(), ep[3].bias.float().contiguous())
    x2h, h2x = pack_pass_params(refine_net, dtype)
    return PackedBlock(ew=ew, x2h=x2h, h2x=h2x)


def entry(name: str, dtype) -> str:
    """The C entry point of `name` for kernels of `dtype`."""
    return name + "_bf16" if check_dtype(dtype) == torch.bfloat16 else name


def require_pack(stacks_dtype, dtype, what: str = "packed weights") -> None:
    """Raise unless weights packed as `stacks_dtype` are for kernels of `dtype`."""
    if stacks_dtype != check_dtype(dtype):
        raise ValueError(f"{what} are packed for {stacks_dtype} kernels, not {dtype}: pack "
                         f"them with dtype={dtype}")


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.load_library()
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        # x, idx, B, N, K, offsets, coeff, EwParams, ew, stream
        "td_block_ew": [vp, vp, i32, i32, i32, vp, f32, _EwParams, vp, vp],
        # h, rows, PassParams, ni, nj, q, stream
        "td_block_node": [vp, i32, _PassParams, vp, vp, vp, vp],
        # h, B, N, row0, PassParams, ni, nj, q, q1, stream
        "td_block_node_rows": [vp, i32, i32, i32, _PassParams, vp, vp, vp, vp, vp],
        # h, x, idx, nmask, mlig, ew, ni, nj, q, offsets, coeff, PassParams,
        # B, N, K, row0, out, stream (td_block_h2x: no h)
        "td_block_x2h": [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, f32, _PassParams,
                         i32, i32, i32, i32, vp, vp],
        "td_block_h2x": [vp, vp, vp, vp, vp, vp, vp, vp, vp, f32, _PassParams,
                         i32, i32, i32, i32, vp, vp],
        # as td_block_x2h with (order, count) in place of row0
        "td_block_x2h_list": [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, f32, _PassParams,
                              i32, i32, i32, vp, vp, vp, vp],
        # h, rows, order, dst count, src count, PassParams, ni, nj, q, stream
        "td_block_node_list": [vp, i32, vp, vp, vp, _PassParams, vp, vp, vp, vp],
        # h0, x0, idx, nmask, mlig, ew, offsets, coeff, x2h[L], h2x[L], L, B, N, K,
        # n_ligand, ni, nj, q, hck, xck, stream
        "td_block_train_fwd": [vp, vp, vp, vp, vp, vp, vp, f32, ctypes.POINTER(_PassParams),
                               ctypes.POINTER(_PassParams), i32, i32, i32, i32, i32, vp, vp,
                               vp, vp, vp, vp],
    }
    sigs.update({entry(name, torch.bfloat16): sigs[name] for name in (
        "td_block_ew", "td_block_node", "td_block_node_rows", "td_block_x2h", "td_block_h2x",
        "td_block_train_fwd", "td_block_x2h_list", "td_block_node_list")})
    fns = {}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def node_launch_counts() -> tuple:
    """(float32, bf16) node-kernel launches the library has made in this
    process, counted in C where launch_node launches (td_node_launches,
    td_node_bf16_launches): by the blocks, the train-mode forward, the
    per-layer passes and the backward's recompute."""
    lib = build.load_library()
    counts = (lib.td_node_launches, lib.td_node_bf16_launches)
    for fn in counts:
        fn.argtypes, fn.restype = [], ctypes.c_longlong
    return tuple(fn() for fn in counts)


def _pass_structs(stacks: dict, num_layers: int):
    return [_PassParams(*[stacks[name][l].data_ptr() for name, _ in _PassParams._fields_])
            for l in range(num_layers)]


def block_denoiser(refine_net, h, x, nbh: G.Neighborhood, mask_ligand, n_ligand: int,
                   packed: PackedBlock = None, fix_x: bool = False, dtype=torch.float32,
                   cone=None):
    """All layers of one UniTransformerO2 block. h [B,N,H] f32, x [B,N,3]
    f32, nbh [B,N,K], mask_ligand [B,N] bool (ligand rows are the last
    `n_ligand` rows). fix_x=True keeps x as given and skips the h2x pass.
    dtype: the products' precision, torch.float32 or torch.bfloat16 (h and x
    stay float32). cone: a `cone.Cone` of nbh's graph (not with fix_x): each
    layer computes only the rows of its cone; x and the ligand rows of h
    come out as without it, bit for bit, the protein rows of h stale.
    Returns (h, x) after the block. Inference only: the CUDA path records
    no autograd graph."""
    check_dtype(dtype)
    if h.device.type == "cpu":
        return refine_net.block_forward(h, x, nbh, mask_ligand, fix_x=fix_x, dtype=dtype,
                                        cone=cone)
    return block_denoiser_cuda(refine_net, h, x, nbh, mask_ligand, n_ligand, packed, fix_x,
                               dtype, cone)


def check_block_inputs(refine_net, h, x, nbh, mask_ligand, n_ligand):
    """Raise unless the inputs are what the block kernels take."""
    for name, t in (("h", h), ("x", x), ("idx", nbh.idx), ("nbr_mask", nbh.mask),
                    ("mask_ligand", mask_ligand)):
        build.require_cuda(t, name)
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
    B, N, H = h.shape
    K = nbh.idx.shape[-1]
    if (H, refine_net.n_heads) != (HIDDEN, HEADS):
        raise ValueError(f"the block kernels take hidden={HIDDEN}, heads={HEADS}; "
                         f"got {H}, {refine_net.n_heads}")
    if not 0 < K <= MAX_K:
        raise ValueError(f"the block kernels take 1 <= K <= {MAX_K}, got K={K}")
    if not 0 < n_ligand <= N:
        raise ValueError(f"n_ligand={n_ligand} must lie in [1, N={N}]")
    if h.dtype != torch.float32 or x.dtype != torch.float32 or x.shape != (B, N, 3):
        raise ValueError("h [B,N,H] and x [B,N,3] must be float32")
    if nbh.idx.dtype != torch.int64 or nbh.idx.shape != (B, N, K) or nbh.mask.shape != (B, N, K):
        raise ValueError("idx must be int64 [B,N,K] with a bool mask of the same shape")
    if (nbh.mask.dtype != torch.bool or mask_ligand.dtype != torch.bool
            or mask_ligand.shape != (B, N)):
        raise ValueError("nbr_mask and mask_ligand must be bool")


def check_cone(cone, B: int, N: int, L: int, device) -> None:
    """Raise unless `cone` is the cone of a graph of B complexes of N rows
    for L layers, on `device`."""
    if cone.num_layers != L or cone.order.shape != (B * N,) or cone.hop.shape != (B, N):
        raise ValueError(f"the cone is for {cone.num_layers} layers over "
                         f"{tuple(cone.hop.shape)} rows, the block has {L} layers over "
                         f"({B}, {N})")
    for t in cone:
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"the cone's tensors must be contiguous int32 on {device}")


def block_denoiser_cuda(refine_net, h, x, nbh, mask_ligand, n_ligand, packed=None,
                        fix_x: bool = False, dtype=torch.float32, cone=None):
    global LAUNCHES, X2H_PASS_LAUNCHES, H2X_PASS_LAUNCHES
    global BF16_LAUNCHES, BF16_X2H_PASS_LAUNCHES, BF16_H2X_PASS_LAUNCHES
    check_block_inputs(refine_net, h, x, nbh, mask_ligand, n_ligand)
    B, N, H = h.shape
    K = nbh.idx.shape[-1]
    if packed is None:
        with torch.no_grad():
            packed = pack_block_params(refine_net, dtype)
    require_pack(packed.dtype, dtype)
    if packed.ew[0].device != h.device:
        raise ValueError(f"packed weights are on {packed.ew[0].device}, h on {h.device}")
    bf16 = dtype == torch.bfloat16

    dev = h.device
    L = packed.x2h["w_node"].shape[0]
    if cone is not None:
        if fix_x:
            raise ValueError("the cone skips rows the h2x pass would not read; with fix_x every "
                             "row of h is an output")
        check_cone(cone, B, N, L, dev)
    fns = _entries()
    stream = build.stream_ptr(dev)
    offsets, coeff = gaussian_smearing_offsets(device=dev)
    idx, nmask, mlig = nbh.idx.contiguous(), nbh.mask.contiguous(), mask_ligand.contiguous()
    h_a = h.contiguous().clone()
    # with a cone the rows a layer skips keep what its output buffer held
    h_b = torch.empty_like(h) if cone is None else h_a.clone()
    if fix_x:
        x_a = x_b = x.contiguous()  # read only: no h2x pass writes it
    else:
        x_a, x_b = x.contiguous().clone(), x.contiguous().clone()  # protein rows never move
    ew = torch.empty((B, N, K), dtype=torch.float32, device=dev)
    ni = torch.empty((B * N, 2 * H), dtype=torch.float32, device=dev)
    nj = torch.empty_like(ni)
    q = torch.empty((B * N, H), dtype=torch.float32, device=dev)
    x2h_p, h2x_p = _pass_structs(packed.x2h, L), _pass_structs(packed.h2x, L)

    _launch_ew(x_a, idx, packed, ew)
    common = (idx.data_ptr(), nmask.data_ptr(), mlig.data_ptr(), ew.data_ptr(),
              ni.data_ptr(), nj.data_ptr(), q.data_ptr(), offsets.data_ptr(), coeff)
    node, node_rows, x2h, h2x, node_list, x2h_list = (entry(n, dtype) for n in (
        "td_block_node", "td_block_node_rows", "td_block_x2h", "td_block_h2x",
        "td_block_node_list", "td_block_x2h_list"))
    if cone is not None:
        order, counts = cone.order.data_ptr(), cone.counts.data_ptr()

        def count(k):  # the device address of counts[k], the rows of hop <= k
            return counts + 4 * k

    for l in range(L):
        if cone is None:
            build.check(fns[node](h_a.data_ptr(), B * N, x2h_p[l], ni.data_ptr(),
                                  nj.data_ptr(), q.data_ptr(), stream), node)
            build.check(fns[x2h](h_a.data_ptr(), x_a.data_ptr(), *common, x2h_p[l],
                                 B, N, K, 0, h_b.data_ptr(), stream), x2h)
        else:
            build.check(fns[node_list](h_a.data_ptr(), B * N, order, count(L - l),
                                       count(L - l + 1), x2h_p[l], ni.data_ptr(),
                                       nj.data_ptr(), q.data_ptr(), stream), node_list)
            build.check(fns[x2h_list](h_a.data_ptr(), x_a.data_ptr(), *common, x2h_p[l],
                                      B, N, K, order, count(L - l), h_b.data_ptr(), stream),
                        x2h_list)
        if bf16:
            BF16_X2H_PASS_LAUNCHES += 1
        else:
            X2H_PASS_LAUNCHES += 1
        h_a, h_b = h_b, h_a
        if fix_x:
            continue
        # the h2x pass needs of the protein rows only their source projections
        # (with a cone, of the ligand rows' sources: hop <= 1)
        if cone is None:
            build.check(fns[node_rows](h_a.data_ptr(), B, N, N - n_ligand, h2x_p[l],
                                       ni.data_ptr(), nj.data_ptr(), q.data_ptr(), None,
                                       stream), node_rows)
        else:
            build.check(fns[node_list](h_a.data_ptr(), B * N, order, count(0), count(1),
                                       h2x_p[l], ni.data_ptr(), nj.data_ptr(), q.data_ptr(),
                                       stream), node_list)
        build.check(fns[h2x](x_a.data_ptr(), *common, h2x_p[l],
                             B, N, K, N - n_ligand, x_b.data_ptr(), stream), h2x)
        if bf16:
            BF16_H2X_PASS_LAUNCHES += 1
        else:
            H2X_PASS_LAUNCHES += 1
        x_a, x_b = x_b, x_a
    if bf16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return h_a, x_a


def node_projections_plain(h, stacks, layer: int = 0):
    """The per-node projections of one pass (csrc/node_proj.cuh) in plain
    PyTorch: h [..., H] -> ni [..., 2H], nj [..., 2H], q [..., H] and the
    query MLP's first-layer output q1 [..., H], from layer `layer` of
    `pack_pass_params`-style stacks; bf16 stacks: the bf16 kernel's version,
    h and the LayerNorm output rounded to bf16, the products in h's dtype
    (float32; float64 for a reference)."""
    p = {k: v[layer] for k, v in stacks.items()}
    H = h.shape[-1]
    bf16 = p["w_node"].dtype == torch.bfloat16
    if bf16:
        h = round_bf16(h)
        p = {k: v.to(h.dtype) for k, v in p.items()}
    proj = h @ p["w_node"] + p["b_node"]  # [k.h_i | v.h_i | k.h_j | v.h_j | q1]
    q1 = proj[..., 4 * H:]
    z = torch.relu(torch.nn.functional.layer_norm(q1, (H,), p["q_ln"][0], p["q_ln"][1], 1e-5))
    q = (round_bf16(z) if bf16 else z) @ p["w_q2"] + p["b_q2"]
    return proj[..., :2 * H], proj[..., 2 * H:4 * H], q, q1


NODE_TILE_ROWS = 64  # rows of a tile of the node kernel (csrc/node_proj.cuh kNodeRows)


def node_deal(tiles_dst: int, tiles_all: int, warpgroups: int, slots: int) -> list:
    """Blocks of the node kernel's three column groups (ni, nj, q), as
    csrc/node_proj.cuh `node_deal` deals them: as many as give each of a
    group's warpgroups one tile, but no more than the group's share, by
    tiles, of the `slots` blocks the card holds at once (at least one)."""
    total = 2 * tiles_dst + tiles_all
    return [min(-(-t // warpgroups), max(1, slots * t // total if total else 0))
            for t in (tiles_dst, tiles_all, tiles_dst)]


def node_walk(B: int, N: int, row0: int, slots: int, warpgroups: int, lists=None) -> list:
    """The node kernel's tile walk (csrc/node_proj.cuh node_kernel) replayed:
    one (column group, [row arrays]) per block, the arrays the node rows
    (b*N + i) of the tiles each of its warpgroups takes, in its order. The
    ni and q groups walk rows [row0, N) of each complex, nj every row; a
    group's warpgroups take its tiles with the stride of their number.
    lists=(n_dst, n_src), a row list's counts (`td_block_node_list`): the
    arrays hold positions u in the list (row order[u]), ni and q walk u <
    n_dst, nj u < n_src, and the blocks deal the `slots` to the groups from
    those counts on a grid of slots + 3, the blocks past the deal taking
    none (left out)."""
    import numpy as np

    nd = N - row0
    nrows = (B * nd, B * N, B * nd) if lists is None else (lists[0], lists[1], lists[0])
    tiles = [-(-n // NODE_TILE_ROWS) for n in nrows]
    nb = node_deal(tiles[0], tiles[1], warpgroups, slots)
    blocks = []
    for grp in range(3):
        stride = nb[grp] * warpgroups
        for j in range(nb[grp]):
            walks = []
            for wg in range(warpgroups):
                rows = []
                for tile in range(j * warpgroups + wg, tiles[grp], stride):
                    u = np.arange(tile * NODE_TILE_ROWS,
                                  min((tile + 1) * NODE_TILE_ROWS, nrows[grp]))
                    rows.append(u if grp == 1 or lists else u // nd * N + row0 + u % nd)
                walks.append(rows)
            blocks.append((grp, walks))
    return blocks


def node_projections_cuda(h, stacks, layer: int = 0, row0: int = 0, want_q1: bool = False):
    """The node kernel alone (csrc/node_proj.cuh): (ni, nj, q, q1) of h
    [B,N,H] for layer `layer` of `pack_pass_params`-style stacks, each
    [B*N, width]. With row0 > 0 the rows below row0 of each complex get only
    nj (as the h2x pass launches it; their ni and q are left unset). q1 is
    None unless asked for. bf16 stacks launch the bf16 node kernel. CUDA
    tensors only; `node_projections_plain` is its plain version."""
    build.require_cuda(h, "h")
    B, N, H = h.shape
    if H != HIDDEN or h.dtype != torch.float32:
        raise ValueError(f"the node kernel takes float32 h of width {HIDDEN}, got {h.dtype} "
                         f"{tuple(h.shape)}")
    if not 0 <= row0 < N:
        raise ValueError(f"row0={row0} must lie in [0, N={N})")
    if stacks["w_node"].device != h.device:
        raise ValueError(f"packed weights are on {stacks['w_node'].device}, h on {h.device}")
    h = h.detach().contiguous()
    ni = torch.empty((B * N, 2 * H), dtype=torch.float32, device=h.device)
    nj = torch.empty_like(ni)
    q = torch.empty((B * N, H), dtype=torch.float32, device=h.device)
    q1 = torch.empty_like(q) if want_q1 else None
    name = entry("td_block_node_rows", stacks["w_node"].dtype)
    build.check(_entries()[name](
        h.data_ptr(), B, N, row0, _pass_structs(stacks, layer + 1)[layer], ni.data_ptr(),
        nj.data_ptr(), q.data_ptr(), None if q1 is None else q1.data_ptr(),
        build.stream_ptr(h.device)), name)
    return ni, nj, q, q1


def _launch_ew(x, idx, packed: PackedBlock, out):
    """ew_kernel of the pack's dtype on contiguous x [B,N,3] and idx
    [B,N,K] into out [B,N,K]."""
    global EW_LAUNCHES, BF16_EW_LAUNCHES
    B, N, K = idx.shape
    offsets, coeff = gaussian_smearing_offsets(device=x.device)
    name = entry("td_block_ew", packed.dtype)
    build.check(_entries()[name](
        x.data_ptr(), idx.data_ptr(), B, N, K, offsets.data_ptr(), coeff,
        _EwParams(*[t.data_ptr() for t in packed.ew]), out.data_ptr(),
        build.stream_ptr(x.device)), name)
    if packed.dtype == torch.bfloat16:
        BF16_EW_LAUNCHES += 1
    else:
        EW_LAUNCHES += 1


def edge_weights_cuda(x, nbh: G.Neighborhood, packed: PackedBlock):
    """The edge-weight kernel alone (csrc/block_denoiser.cu ew_kernel, as
    `block_denoiser_cuda` launches it once per block call): e_w [B,N,K] =
    sigmoid(w2 . relu(LN(rbf(d) @ w1 + b1)) + b2) of every slot of the graph
    on positions x [B,N,3], from `pack_block_params`' edge-weight weights
    (a bf16 pack launches the bf16 kernel). Slots past a row's valid
    neighbours get a value too; callers read the valid ones. CUDA tensors
    only; the module's `edge_weights` (with the pack's dtype) is its plain
    version."""
    build.require_cuda(x, "x")
    B, N, _ = x.shape
    K = nbh.idx.shape[-1]
    if x.dtype != torch.float32 or x.shape != (B, N, 3):
        raise ValueError(f"x must be float32 [B,N,3], got {x.dtype} {tuple(x.shape)}")
    if nbh.idx.dtype != torch.int64 or nbh.idx.shape != (B, N, K) or nbh.idx.device != x.device:
        raise ValueError(f"idx must be int64 [B,N,K] on {x.device}")
    if packed.ew[0].device != x.device:
        raise ValueError(f"packed weights are on {packed.ew[0].device}, x on {x.device}")
    ew = torch.empty((B, N, K), dtype=torch.float32, device=x.device)
    _launch_ew(x.detach().contiguous(), nbh.idx.contiguous(), packed, ew)
    return ew


@torch.no_grad()
def block_denoiser_train_plain(refine_net, h, x, nbh, mask_ligand, e_w, dtype=torch.float32):
    """The plain version of the train-mode kernels of `dtype` (eager layers,
    any device), with their outputs: the checkpoints hck [L+1,B,N,H] and xck
    [L+1,B,N,3], slot 0 the input and slot l + 1 the output of layer l."""
    edge_attr = G.edge_types(nbh, mask_ligand)
    hs, xs = [h], [x]
    for layer in refine_net.base_block:
        h, x = layer(h, x, edge_attr, nbh, mask_ligand, e_w[..., None], dtype=dtype)
        hs.append(h)
        xs.append(x)
    return torch.stack(hs), torch.stack(xs)


def block_denoiser_train_cuda(refine_net, h, x, nbh, mask_ligand, e_w, n_ligand, x2h, h2x,
                              dtype=torch.float32):
    """Train-mode forward of all layers of one block with the edge weights
    e_w [B,N,K] given; x2h / h2x are `pack_pass_params` stacks for the
    kernels of `dtype` (bf16: `cast_pack` of the float32 ones). Returns the
    float32 checkpoints hck [L+1,B,N,H] and xck [L+1,B,N,3] (the block's
    output is slot L). No autograd graph: ops/kernels/block_vjp.py
    differentiates it."""
    global TRAIN_LAUNCHES, BF16_TRAIN_LAUNCHES
    check_block_inputs(refine_net, h, x, nbh, mask_ligand, n_ligand)
    B, N, H = h.shape
    K = nbh.idx.shape[-1]
    if e_w.shape != (B, N, K) or e_w.dtype != torch.float32 or e_w.device != h.device:
        raise ValueError(f"e_w must be float32 [B,N,K] on {h.device}")
    L = x2h["w_node"].shape[0]
    require_pack(x2h["w_node"].dtype, dtype, "the train-mode kernels' weights")
    require_pack(h2x["w_node"].dtype, dtype, "the train-mode kernels' weights")
    if x2h["w_node"].device != h.device:
        raise ValueError(f"packed weights are on {x2h['w_node'].device}, h on {h.device}")
    dev = h.device
    offsets, coeff = gaussian_smearing_offsets(device=dev)
    h0, x0 = h.detach().contiguous(), x.detach().contiguous()
    idx, nmask, mlig = nbh.idx.contiguous(), nbh.mask.contiguous(), mask_ligand.contiguous()
    ew = e_w.detach().contiguous()
    hck = torch.empty((L + 1, B, N, H), dtype=torch.float32, device=dev)
    xck = torch.empty((L + 1, B, N, 3), dtype=torch.float32, device=dev)
    ni = torch.empty((B * N, 2 * H), dtype=torch.float32, device=dev)
    nj = torch.empty_like(ni)
    q = torch.empty((B * N, H), dtype=torch.float32, device=dev)
    x2h_p = (_PassParams * L)(*_pass_structs(x2h, L))
    h2x_p = (_PassParams * L)(*_pass_structs(h2x, L))
    name = entry("td_block_train_fwd", dtype)
    build.check(_entries()[name](
        h0.data_ptr(), x0.data_ptr(), idx.data_ptr(), nmask.data_ptr(), mlig.data_ptr(),
        ew.data_ptr(), offsets.data_ptr(), coeff, x2h_p, h2x_p, L, B, N, K, n_ligand,
        ni.data_ptr(), nj.data_ptr(), q.data_ptr(), hck.data_ptr(), xck.data_ptr(),
        build.stream_ptr(dev)), name)
    if dtype == torch.bfloat16:
        BF16_TRAIN_LAUNCHES += 1
    else:
        TRAIN_LAUNCHES += 1
    return hck, xck
