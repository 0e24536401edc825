"""SE(3)-equivariant graph transformer, eager PyTorch, counterpart of
targetdiff_tpu/models/uni_transformer.py (reference:
models/uni_transformer.py:11-328) on dense [B, N, K] neighborhoods.

Every uni_o2 option of the JAX package's XLA path is built: edge weights
`ew_net_type` 'global' (one MLP over block-start distances), 'r' (each
sub-layer's `ew_net` over its RBF features), 'm' (the x2h sub-layers'
`ew_net` over their values; 1 in h2x) or 'none'; the x2h output MLP
(`x2h_out_fc`, `node_output`); `num_x2h` chained x2h and `num_h2x` h2x
sub-layers a layer, the h2x ones fed the layer's input h (`sync_twoup`) or
the x2h output; any activation of `common.get_activation`; MLPs with or
without LayerNorm; without edge features in the attention inputs
(`edge_feat_dim` 0); over a kNN or a hybrid graph. `model_dtype`
torch.bfloat16 is JAX's bf16 model (ops/precision.py model_linear).
The released architecture (global, no output MLP, one x2h and one h2x,
relu, norm, float32) is what the kernels compute:
`UniTransformerO2TwoUpdateGeneral.block_forward` is the plain version of the
block-denoiser kernel (ops/kernels/block_denoiser.py); one layer's x2h and
h2x sub-layers with the edge weights given are the plain versions of the
per-layer kernels (ops/kernels/edge_layer.py). Each takes `dtype`:
torch.bfloat16 is the plain version of the bf16 kernels, every dense
product's operands rounded to bf16 and multiplied in float32
(ops/precision.py); torch.float32 (the default) is unchanged. Under autograd
the bf16 products are `precision.Bf16Linear` (bf16 operands backward too),
the plain version of the bf16 backward kernels (JAX's bf16 training
variant). The released architecture's kNN graph here is the plain
`ops.graph.knn_graph`, which the kernels are held against; every other
configuration builds its graph on the kNN kernel (ops/kernels/knn.py) for
CUDA tensors, once a block.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops import graph as G
from ..ops import precision
from ..ops.kernels.knn import knn_graph
from ..ops.rbf import gaussian_smearing, gaussian_smearing_offsets
from .common import MLP, outer_product

NEG_INF = -1e9


def masked_neighbor_softmax(logits: torch.Tensor, nbr_mask: torch.Tensor) -> torch.Tensor:
    """Max-shifted softmax over K of [B, N, K, heads]; invalid neighbors get
    weight 0 and rows without a valid neighbor give zeros."""
    m = nbr_mask[..., None]
    logits = torch.where(m, logits, torch.full((), NEG_INF, device=logits.device))
    logits = logits - logits.amax(dim=2, keepdim=True)
    unnorm = torch.where(m, torch.exp(logits), torch.zeros((), device=logits.device))
    return unnorm / unnorm.sum(dim=2, keepdim=True).clamp(min=1e-16)


EDGE_TYPES = 4  # the edge-type one-hot: (src, dst) ligand / protein
EW_NET_TYPES = ("global", "r", "m", "none")


def edge_geometry(x, nbh, edge_attr, model_dtype=torch.float32):
    """rel [B,N,K,3] = x_dst - x_src and the edge features r_feat [B,N,K,4R]
    = edge type (x) RBF(distance) of a graph, the RBF rounded to the model
    dtype first (targetdiff_tpu/models/uni_transformer.py:194-195)."""
    offsets, coeff = gaussian_smearing_offsets(device=x.device)
    rel_x, dist = G.rel_geometry(x, nbh)
    rbf = precision.to_model(gaussian_smearing(dist, offsets, coeff), model_dtype)
    return rel_x, outer_product(edge_attr, rbf)


class _EdgeAttention(nn.Module):
    """Shared k/v/q MLPs of one attention sub-layer; kv input is
    [edge_feat(edge_feat_dim) | r_feat(4R) | h_i | h_j], without edge_feat
    when edge_feat_dim is 0. Its own edge-weight Linear `ew_net.0` where the
    type has one ('r'; 'm' in x2h)."""

    def __init__(self, hidden_dim, n_heads, edge_feat_dim, r_feat_dim, v_dim, prefix,
                 act_fn="relu", norm=True, ew_net_type="global", model_dtype=torch.float32):
        super().__init__()
        self.n_heads, self.edge_feat_dim = n_heads, edge_feat_dim
        self.ew_net_type, self.model_dtype = ew_net_type, model_dtype
        kv_in = edge_feat_dim + r_feat_dim + 2 * hidden_dim
        mlp = dict(norm=norm, act_fn=act_fn, model_dtype=model_dtype)
        setattr(self, f"{prefix}k_func", MLP(kv_in, hidden_dim, hidden_dim, **mlp))
        setattr(self, f"{prefix}v_func", MLP(kv_in, v_dim, hidden_dim, **mlp))
        if ew_net_type == "r":
            self.ew_net = nn.Sequential(nn.Linear(r_feat_dim, 1), nn.Sigmoid())
        elif ew_net_type == "m" and prefix == "h":
            self.ew_net = nn.Sequential(nn.Linear(hidden_dim, 1), nn.Sigmoid())
        setattr(self, f"{prefix}q_func", MLP(hidden_dim, hidden_dim, hidden_dim, **mlp))
        self._prefix = prefix

    def edge_weight(self, r_feat, v, e_w):
        """The sub-layer's edge weights [B,N,K,1], or None for none: its
        ew_net's where it has one, the block's e_w under 'global'."""
        if hasattr(self, "ew_net"):
            feat = r_feat if self.ew_net_type == "r" else v
            return torch.sigmoid(precision.model_linear(feat, self.ew_net[0], self.model_dtype))
        return e_w if self.ew_net_type == "global" else None

    def attention(self, h, r_feat, edge_feat, nbh, e_w, dtype=torch.float32, h_src=None):
        """h_src: the rows nbh.idx names, where they are not h's own (a row
        set's sources)."""
        B, N, H = h.shape
        K = nbh.idx.shape[-1]
        dh = H // self.n_heads
        p = self._prefix
        parts = [r_feat, h[:, :, None, :].expand(B, N, K, H),
                 G.gather_nodes(h if h_src is None else h_src, nbh.idx)]
        if self.edge_feat_dim > 0:
            parts.insert(0, edge_feat)
        kv_input = torch.cat(parts, dim=-1)
        k = getattr(self, f"{p}k_func")(kv_input, dtype).reshape(B, N, K, self.n_heads, dh)
        v = getattr(self, f"{p}v_func")(kv_input, dtype)
        e_w = self.edge_weight(r_feat, v, e_w)
        if e_w is not None:
            v = v * e_w
        q = getattr(self, f"{p}q_func")(h, dtype).reshape(B, N, self.n_heads, dh)
        logits = (q[:, :, None] * k).sum(-1) / math.sqrt(dh)  # [B, N, K, heads]
        return masked_neighbor_softmax(logits, nbh.mask), v


class BaseX2HAttLayer(_EdgeAttention):
    """Invariant-feature attention sub-layer (reference: :11-84), with the
    output MLP `node_output` over [out | h] before the residual when out_fc."""

    def __init__(self, hidden_dim, n_heads, edge_feat_dim, r_feat_dim, act_fn="relu",
                 norm=True, ew_net_type="global", out_fc=False, model_dtype=torch.float32):
        super().__init__(hidden_dim, n_heads, edge_feat_dim, r_feat_dim, hidden_dim, "h",
                         act_fn, norm, ew_net_type, model_dtype)
        self.out_fc = out_fc
        if out_fc:
            self.node_output = MLP(2 * hidden_dim, hidden_dim, hidden_dim, norm=norm,
                                   act_fn=act_fn, model_dtype=model_dtype)

    def forward(self, h, r_feat, edge_feat, nbh, e_w, dtype=torch.float32, h_src=None):
        B, N, H = h.shape
        alpha, v = self.attention(h, r_feat, edge_feat, nbh, e_w, dtype, h_src)
        v = v.reshape(B, N, -1, self.n_heads, H // self.n_heads)
        out = (alpha[..., None] * v).sum(dim=2).reshape(B, N, H)
        if self.out_fc:
            out = self.node_output(torch.cat([out, h], dim=-1), dtype)
        return out + h


class BaseH2XAttLayer(_EdgeAttention):
    """Equivariant coordinate-update sub-layer (reference: :87-140): per-head
    scalar gates on rel_x, averaged over heads; the gate and the update in
    the positions' dtype (float32) whatever the model dtype."""

    def __init__(self, hidden_dim, n_heads, edge_feat_dim, r_feat_dim, act_fn="relu",
                 norm=True, ew_net_type="global", model_dtype=torch.float32):
        super().__init__(hidden_dim, n_heads, edge_feat_dim, r_feat_dim, n_heads, "x",
                         act_fn, norm, ew_net_type, model_dtype)

    def forward(self, h, rel_x, r_feat, edge_feat, nbh, e_w, dtype=torch.float32, h_src=None):
        alpha, v = self.attention(h, r_feat, edge_feat, nbh, e_w, dtype, h_src)  # v [B, N, K, heads]
        s = (alpha * v).mean(dim=-1)
        return torch.einsum("bnk,bnkd->bnd", s.to(rel_x.dtype), rel_x)


class AttentionLayerO2TwoUpdateNodeGeneral(nn.Module):
    """One layer: num_x2h chained feature updates on the layer's starting
    geometry, then num_h2x coordinate updates of the ligand rows, each fed h
    (sync_twoup) or the x2h output, the geometry recomputed after each
    (reference: :143-210; targetdiff_tpu/models/uni_transformer.py:186-216)."""

    def __init__(self, hidden_dim, n_heads, num_r_gaussian, edge_feat_dim, act_fn="relu",
                 norm=True, num_x2h=1, num_h2x=1, ew_net_type="global", x2h_out_fc=False,
                 sync_twoup=False, model_dtype=torch.float32):
        super().__init__()
        r_feat_dim = num_r_gaussian * EDGE_TYPES
        sub = dict(act_fn=act_fn, norm=norm, ew_net_type=ew_net_type, model_dtype=model_dtype)
        self.sync_twoup, self.model_dtype = sync_twoup, model_dtype
        self.x2h_layers = nn.ModuleList(
            [BaseX2HAttLayer(hidden_dim, n_heads, edge_feat_dim, r_feat_dim, out_fc=x2h_out_fc,
                             **sub) for _ in range(num_x2h)])
        self.h2x_layers = nn.ModuleList(
            [BaseH2XAttLayer(hidden_dim, n_heads, edge_feat_dim, r_feat_dim, **sub)
             for _ in range(num_h2x)])

    def forward(self, h, x, edge_attr, nbh, mask_ligand, e_w, fix_x: bool = False,
                dtype=torch.float32):
        """fix_x=True freezes the coordinates: x comes back as given. The
        h2x outputs feed x alone, so they are not computed then."""
        rel_x, r_feat = edge_geometry(x, nbh, edge_attr, self.model_dtype)
        h_in = h
        for layer in self.x2h_layers:
            h_in = layer(h_in, r_feat, edge_attr, nbh, e_w, dtype)
        if fix_x:
            return h_in, x
        new_h = h if self.sync_twoup else h_in
        for i, layer in enumerate(self.h2x_layers):
            if i > 0:
                rel_x, r_feat = edge_geometry(x, nbh, edge_attr, self.model_dtype)
            delta_x = layer(new_h, rel_x, r_feat, edge_attr, nbh, e_w, dtype)
            x = x + delta_x * mask_ligand[..., None].to(x.dtype)
        return h_in, x

    def forward_rows(self, h, x, edge_attr, nbh, mask_ligand, e_w, rows, lig_rows,
                     dtype=torch.float32):
        """The layer on row sets (the plain version of the block kernels
        with a dependency cone, ops/kernels/cone.py): the x2h output on the
        rows `rows` and the h2x update on the ligand rows `lig_rows` (int64
        row numbers b*N + i), each row from its own inputs and the sources
        its valid edges name; a slot without a valid edge names its own row,
        as the kernels read no source there. Every other row of h and x
        keeps its value. One x2h and one h2x sub-layer, the kernels'
        architecture."""
        if len(self.x2h_layers) != 1 or len(self.h2x_layers) != 1 or self.sync_twoup:
            raise ValueError("row sets take one x2h and one h2x sub-layer without sync_twoup")
        B, N, H = h.shape
        rel_x, r_feat = edge_geometry(x, nbh, edge_attr, self.model_dtype)
        base = (torch.arange(B, device=h.device) * N).view(B, 1, 1)
        own = torch.arange(B * N, device=h.device).view(B, N, 1)
        src = torch.where(nbh.mask, nbh.idx + base, own)

        def flat(t):
            return t.reshape((B * N,) + t.shape[2:])

        def pick(t, r):  # the rows r of t [B, N, ...] as one complex [1, len(r), ...]
            return None if t is None else flat(t).index_select(0, r)[None]

        def edges(r):
            return G.Neighborhood(idx=pick(src, r), mask=pick(nbh.mask, r))

        out = self.x2h_layers[0](pick(h, rows), pick(r_feat, rows), pick(edge_attr, rows),
                                 edges(rows), pick(e_w, rows), dtype, h_src=flat(h)[None])
        h = flat(h).index_copy(0, rows, out[0]).view(B, N, H)
        delta_x = self.h2x_layers[0](pick(h, lig_rows), pick(rel_x, lig_rows),
                                     pick(r_feat, lig_rows), pick(edge_attr, lig_rows),
                                     edges(lig_rows), pick(e_w, lig_rows), dtype,
                                     h_src=flat(h)[None])
        x_lig = pick(x, lig_rows) + delta_x * pick(mask_ligand, lig_rows)[..., None].to(x.dtype)
        return h, flat(x).index_copy(0, lig_rows, x_lig[0]).view(B, N, 3)


class UniTransformerO2TwoUpdateGeneral(nn.Module):
    """num_blocks graph rebuilds x num_layers shared attention layers
    (reference: :213-328). cutoff_mode 'knn' connects each row to its k
    nearest atoms; 'hybrid' (targetdiff_tpu/models/uni_transformer.py:
    240-259) connects a ligand row to every other ligand atom and its k
    nearest protein atoms, over max_ligand ligand slots. knn_kernel=True
    builds the kNN graph on the kNN kernel for CUDA tensors (the
    configurations off the block kernels); False on the plain version."""

    def __init__(self, num_blocks, num_layers, hidden_dim, n_heads, k, num_r_gaussian,
                 edge_feat_dim, cutoff_mode: str = "knn", max_ligand: int = 0,
                 act_fn: str = "relu", norm: bool = True, ew_net_type: str = "global",
                 num_x2h: int = 1, num_h2x: int = 1, x2h_out_fc: bool = False,
                 sync_twoup: bool = False, model_dtype=torch.float32, knn_kernel: bool = False):
        super().__init__()
        if cutoff_mode not in ("knn", "hybrid"):
            raise ValueError(f"cutoff_mode must be 'knn' or 'hybrid', got {cutoff_mode!r}")
        if cutoff_mode == "hybrid" and max_ligand <= 0:
            raise ValueError("the hybrid cutoff needs max_ligand > 0")
        if ew_net_type not in EW_NET_TYPES:
            raise ValueError(f"ew_net_type must be one of {EW_NET_TYPES}, got {ew_net_type!r}")
        self.num_blocks, self.k = num_blocks, k
        self.cutoff_mode, self.max_ligand = cutoff_mode, max_ligand
        self.n_heads, self.ew_net_type = n_heads, ew_net_type
        self.model_dtype, self.knn_kernel = model_dtype, knn_kernel
        self.base_block = nn.ModuleList([
            AttentionLayerO2TwoUpdateNodeGeneral(
                hidden_dim, n_heads, num_r_gaussian, edge_feat_dim, act_fn=act_fn, norm=norm,
                num_x2h=num_x2h, num_h2x=num_h2x, ew_net_type=ew_net_type,
                x2h_out_fc=x2h_out_fc, sync_twoup=sync_twoup, model_dtype=model_dtype)
            for _ in range(num_layers)
        ])
        if ew_net_type == "global":
            self.edge_pred_layer = MLP(num_r_gaussian, 1, hidden_dim, model_dtype=model_dtype)

    def num_neighbors(self) -> int:
        """K, the width of the graph's neighbour lists."""
        return self.max_ligand - 1 + self.k if self.cutoff_mode == "hybrid" else self.k

    def graph(self, x, node_mask, mask_ligand) -> G.Neighborhood:
        """The graph of the cutoff mode on positions x [B,N,3]: the plain
        hybrid graph, or the kNN graph (on the kNN kernel with knn_kernel)."""
        if self.cutoff_mode == "hybrid":
            return G.hybrid_graph(x, node_mask, mask_ligand, self.k, self.max_ligand)
        if self.knn_kernel:
            return knn_graph(x.detach(), node_mask, self.k)
        return G.knn_graph(x, node_mask, self.k)

    def edge_weights(self, x, nbh, dtype=torch.float32):
        """Global edge weights from block-start distances (reference: :312-318)."""
        offsets, coeff = gaussian_smearing_offsets(device=x.device)
        _, dist = G.rel_geometry(x, nbh)
        return torch.sigmoid(self.edge_pred_layer(gaussian_smearing(dist, offsets, coeff),
                                                  dtype))

    def block_forward(self, h, x, nbh: G.Neighborhood, mask_ligand, e_w=None,
                      fix_x: bool = False, dtype=torch.float32, cone=None):
        """All layers of one block on a given neighborhood; for the released
        architecture the plain version of the block-denoiser kernel (of its
        bf16 kernels with dtype=torch.bfloat16; differentiated, of the bf16
        backward kernel). With e_w [B,N,K] given (train mode, computed
        outside by the float32 `edge_weights`), the block uses it as it is;
        other edge-weight types take none.
        fix_x=True keeps x as given (the embedding export); edge types keep
        the protein / ligand split of mask_ligand. cone: a `cone.Cone` of
        nbh's graph (the sampler's need_full_h=False; not with fix_x): layer
        l computes x2h on its rows of hop <= L - l and h2x on the ligand
        rows (`forward_rows`), the plain version of the block kernels'
        cone path; the other rows of h keep stale values. Returns (h, x)."""
        if cone is not None and fix_x:
            raise ValueError("the cone skips rows the h2x pass would not read; with fix_x every "
                             "row of h is an output")
        if cone is not None and cone.num_layers != len(self.base_block):
            raise ValueError(f"the cone is for {cone.num_layers} layers, the block has "
                             f"{len(self.base_block)}")
        edge_attr = precision.to_model(G.edge_types(nbh, mask_ligand), self.model_dtype)
        if e_w is not None:
            e_w = e_w[..., None]
        elif self.ew_net_type == "global":
            e_w = self.edge_weights(x, nbh, dtype)
        for l, layer in enumerate(self.base_block):
            if cone is None:
                h, x = layer(h, x, edge_attr, nbh, mask_ligand, e_w, fix_x, dtype)
            else:
                h, x = layer.forward_rows(h, x, edge_attr, nbh, mask_ligand, e_w,
                                          cone.x2h_rows(l).long(), cone.rows(0).long(), dtype)
        return h, x

    def forward(self, h, x, mask_ligand, node_mask, fix_x: bool = False):
        for _ in range(self.num_blocks):
            h, x = self.block_forward(h, x, self.graph(x, node_mask, mask_ligand), mask_ligand,
                                      fix_x=fix_x)
        return h, x
