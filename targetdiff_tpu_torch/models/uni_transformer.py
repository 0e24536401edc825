"""SE(3)-equivariant graph transformer, eager PyTorch, counterpart of
targetdiff_tpu/models/uni_transformer.py (reference:
models/uni_transformer.py:11-328) on dense [B, N, K] neighborhoods.

Only the released architecture is built (global edge weights, no x2h output
MLP, one x2h and one h2x per layer, two-update order), over a kNN or a hybrid
graph; `ScorePosNet` refuses any other config.
`UniTransformerO2TwoUpdateGeneral.block_forward` is the plain version of the
block-denoiser kernel (ops/kernels/block_denoiser.py); one layer's x2h and
h2x sub-layers with the edge weights given are the plain versions of the
per-layer kernels (ops/kernels/edge_layer.py). Each takes `dtype`:
torch.bfloat16 is the plain version of the bf16 kernels, every dense
product's operands rounded to bf16 and multiplied in float32
(ops/precision.py); torch.float32 (the default) is unchanged. Under autograd
the bf16 products are `precision.Bf16Linear` (bf16 operands backward too),
the plain version of the bf16 backward kernels (JAX's bf16 training
variant).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops import graph as G
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


def edge_geometry(x, nbh, edge_attr):
    """rel [B,N,K,3] = x_dst - x_src and the edge features r_feat [B,N,K,4R]
    = edge type (x) RBF(distance) of a graph."""
    offsets, coeff = gaussian_smearing_offsets(device=x.device)
    rel_x, dist = G.rel_geometry(x, nbh)
    return rel_x, outer_product(edge_attr, gaussian_smearing(dist, offsets, coeff))


class _EdgeAttention(nn.Module):
    """Shared k/v/q MLPs of one attention sub-layer; kv input is
    [edge_feat(4) | r_feat(4R) | h_i | h_j]."""

    def __init__(self, hidden_dim, n_heads, edge_feat_dim, r_feat_dim, v_dim, prefix):
        super().__init__()
        self.n_heads = n_heads
        kv_in = edge_feat_dim + r_feat_dim + 2 * hidden_dim
        setattr(self, f"{prefix}k_func", MLP(kv_in, hidden_dim, hidden_dim))
        setattr(self, f"{prefix}v_func", MLP(kv_in, v_dim, hidden_dim))
        setattr(self, f"{prefix}q_func", MLP(hidden_dim, hidden_dim, hidden_dim))
        self._prefix = prefix

    def attention(self, h, r_feat, edge_feat, nbh, e_w, dtype=torch.float32):
        B, N, H = h.shape
        K = nbh.idx.shape[-1]
        dh = H // self.n_heads
        p = self._prefix
        kv_input = torch.cat(
            [edge_feat, r_feat, h[:, :, None, :].expand(B, N, K, H), G.gather_nodes(h, nbh.idx)],
            dim=-1,
        )
        k = getattr(self, f"{p}k_func")(kv_input, dtype).reshape(B, N, K, self.n_heads, dh)
        v = getattr(self, f"{p}v_func")(kv_input, dtype) * e_w
        q = getattr(self, f"{p}q_func")(h, dtype).reshape(B, N, self.n_heads, dh)
        logits = (q[:, :, None] * k).sum(-1) / math.sqrt(dh)  # [B, N, K, heads]
        return masked_neighbor_softmax(logits, nbh.mask), v


class BaseX2HAttLayer(_EdgeAttention):
    """Invariant-feature attention sub-layer (reference: :11-84)."""

    def __init__(self, hidden_dim, n_heads, edge_feat_dim, r_feat_dim):
        super().__init__(hidden_dim, n_heads, edge_feat_dim, r_feat_dim, hidden_dim, "h")

    def forward(self, h, r_feat, edge_feat, nbh, e_w, dtype=torch.float32):
        B, N, H = h.shape
        alpha, v = self.attention(h, r_feat, edge_feat, nbh, e_w, dtype)
        v = v.reshape(B, N, -1, self.n_heads, H // self.n_heads)
        return (alpha[..., None] * v).sum(dim=2).reshape(B, N, H) + h


class BaseH2XAttLayer(_EdgeAttention):
    """Equivariant coordinate-update sub-layer (reference: :87-140): per-head
    scalar gates on rel_x, averaged over heads."""

    def __init__(self, hidden_dim, n_heads, edge_feat_dim, r_feat_dim):
        super().__init__(hidden_dim, n_heads, edge_feat_dim, r_feat_dim, n_heads, "x")

    def forward(self, h, rel_x, r_feat, edge_feat, nbh, e_w, dtype=torch.float32):
        alpha, v = self.attention(h, r_feat, edge_feat, nbh, e_w, dtype)  # v [B, N, K, heads]
        s = (alpha * v).mean(dim=-1)
        return torch.einsum("bnk,bnkd->bnd", s, rel_x)


class AttentionLayerO2TwoUpdateNodeGeneral(nn.Module):
    """One layer: x2h feature update, then h2x coordinate update of the
    ligand rows (reference: :143-210)."""

    def __init__(self, hidden_dim, n_heads, num_r_gaussian, edge_feat_dim):
        super().__init__()
        r_feat_dim = num_r_gaussian * edge_feat_dim
        self.x2h_layers = nn.ModuleList(
            [BaseX2HAttLayer(hidden_dim, n_heads, edge_feat_dim, r_feat_dim)])
        self.h2x_layers = nn.ModuleList(
            [BaseH2XAttLayer(hidden_dim, n_heads, edge_feat_dim, r_feat_dim)])

    def forward(self, h, x, edge_attr, nbh, mask_ligand, e_w, fix_x: bool = False,
                dtype=torch.float32):
        """fix_x=True freezes the coordinates: x comes back as given. The
        h2x output feeds x alone, so it is not computed then."""
        rel_x, r_feat = edge_geometry(x, nbh, edge_attr)
        h = self.x2h_layers[0](h, r_feat, edge_attr, nbh, e_w, dtype)
        if fix_x:
            return h, x
        delta_x = self.h2x_layers[0](h, rel_x, r_feat, edge_attr, nbh, e_w, dtype)
        return h, x + delta_x * mask_ligand[..., None].to(x.dtype)


class UniTransformerO2TwoUpdateGeneral(nn.Module):
    """num_blocks graph rebuilds x num_layers shared attention layers
    (reference: :213-328). cutoff_mode 'knn' connects each row to its k
    nearest atoms; 'hybrid' (targetdiff_tpu/models/uni_transformer.py:
    240-259) connects a ligand row to every other ligand atom and its k
    nearest protein atoms, over max_ligand ligand slots."""

    def __init__(self, num_blocks, num_layers, hidden_dim, n_heads, k, num_r_gaussian,
                 edge_feat_dim, cutoff_mode: str = "knn", max_ligand: int = 0):
        super().__init__()
        if cutoff_mode not in ("knn", "hybrid"):
            raise ValueError(f"cutoff_mode must be 'knn' or 'hybrid', got {cutoff_mode!r}")
        if cutoff_mode == "hybrid" and max_ligand <= 0:
            raise ValueError("the hybrid cutoff needs max_ligand > 0")
        self.num_blocks, self.k = num_blocks, k
        self.cutoff_mode, self.max_ligand = cutoff_mode, max_ligand
        self.n_heads = n_heads
        self.base_block = nn.ModuleList([
            AttentionLayerO2TwoUpdateNodeGeneral(hidden_dim, n_heads, num_r_gaussian,
                                                 edge_feat_dim)
            for _ in range(num_layers)
        ])
        self.edge_pred_layer = MLP(num_r_gaussian, 1, hidden_dim)

    def num_neighbors(self) -> int:
        """K, the width of the graph's neighbour lists."""
        return self.max_ligand - 1 + self.k if self.cutoff_mode == "hybrid" else self.k

    def graph(self, x, node_mask, mask_ligand) -> G.Neighborhood:
        """The plain graph of the cutoff mode on positions x [B,N,3]."""
        if self.cutoff_mode == "hybrid":
            return G.hybrid_graph(x, node_mask, mask_ligand, self.k, self.max_ligand)
        return G.knn_graph(x, node_mask, self.k)

    def edge_weights(self, x, nbh, dtype=torch.float32):
        """Global edge weights from block-start distances (reference: :312-318)."""
        offsets, coeff = gaussian_smearing_offsets(device=x.device)
        _, dist = G.rel_geometry(x, nbh)
        return torch.sigmoid(self.edge_pred_layer(gaussian_smearing(dist, offsets, coeff),
                                                  dtype))

    def block_forward(self, h, x, nbh: G.Neighborhood, mask_ligand, e_w=None,
                      fix_x: bool = False, dtype=torch.float32):
        """All layers of one block on a given neighborhood; the plain version
        of the block-denoiser kernel (of its bf16 kernels with dtype=
        torch.bfloat16; differentiated, of the bf16 backward kernel). With
        e_w [B,N,K] given (train mode, computed outside by the float32
        `edge_weights`), the block uses it as it is.
        fix_x=True keeps x as given (the embedding export); edge types keep
        the protein / ligand split of mask_ligand. Returns (h, x)."""
        edge_attr = G.edge_types(nbh, mask_ligand)
        if e_w is None:
            e_w = self.edge_weights(x, nbh, dtype)
        else:
            e_w = e_w[..., None]
        for layer in self.base_block:
            h, x = layer(h, x, edge_attr, nbh, mask_ligand, e_w, fix_x, dtype)
        return h, x

    def forward(self, h, x, mask_ligand, node_mask, fix_x: bool = False):
        for _ in range(self.num_blocks):
            h, x = self.block_forward(h, x, self.graph(x, node_mask, mask_ligand), mask_ligand,
                                      fix_x=fix_x)
        return h, x
