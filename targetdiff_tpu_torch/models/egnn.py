"""E(n)-equivariant GNN denoiser, eager PyTorch, counterpart of
targetdiff_tpu/models/egnn.py (reference: models/egnn.py:9-133), selected by
`model_type: egnn`. Message passing over dense [B, N, K] neighbourhoods with
masked sums. The graph is rebuilt on the current coordinates before every
layer: the kNN kernel (ops/kernels/knn.py) for CUDA tensors, its plain
version for CPU tensors, or the plain hybrid graph. Everything else is plain
PyTorch, as it is XLA in the JAX package: EGNN has no Pallas kernel there.
`model_dtype` torch.bfloat16 is the JAX package's bf16 EGNN (the MLPs,
`edge_inf` and `x_mlp` in bf16, the coordinate gate and update float32;
ops/precision.py model_linear); the JAX package's `remat` is not ported.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import graph as G
from ..ops import precision
from ..ops.kernels.knn import knn_graph
from .common import MLP

EDGE_TYPES = 4  # the edge features: (src, dst) ligand / protein one-hot


class EnBaseLayer(nn.Module):
    """Classic E(n)-GNN layer (reference: models/egnn.py:9-64) as the denoiser
    builds it (targetdiff_tpu/models/score_model.py:84-95): one distance
    feature (d^2) beside the edge types, silu, no norm. Edge MLP m_ij,
    sigmoid gate e_ij, gated sum over the neighbours, residual node MLP, and
    a tanh-bounded coordinate update of the ligand atoms only."""

    def __init__(self, hidden_dim: int, edge_feat_dim: int, model_dtype=torch.float32):
        super().__init__()
        self.model_dtype = model_dtype
        self.edge_mlp = MLP(2 * hidden_dim + 1 + edge_feat_dim, hidden_dim, hidden_dim,
                            num_layer=2, norm=False, act_fn="silu", act_last=True,
                            model_dtype=model_dtype)
        self.edge_inf = nn.Sequential(nn.Linear(hidden_dim, 1), nn.Sigmoid())
        last = nn.Linear(hidden_dim, 1, bias=False)
        nn.init.xavier_uniform_(last.weight, gain=0.001)
        self.x_mlp = nn.Sequential(nn.Linear(hidden_dim, hidden_dim), nn.SiLU(), last, nn.Tanh())
        self.node_mlp = MLP(2 * hidden_dim, hidden_dim, hidden_dim, num_layer=2, norm=False,
                            act_fn="silu", model_dtype=model_dtype)

    def forward(self, h, x, nbh: G.Neighborhood, mask_ligand, edge_attr, fix_x: bool = False):
        B, N, H = h.shape
        K = nbh.idx.shape[-1]
        md = self.model_dtype
        rel_x, dist = G.rel_geometry(x, nbh)
        mij = self.edge_mlp(torch.cat(
            [h[:, :, None, :].expand(B, N, K, H), G.gather_nodes(h, nbh.idx),
             precision.to_model((dist * dist)[..., None], md), precision.to_model(edge_attr, md)],
            dim=-1))
        eij = precision.model_sequential(self.edge_inf, mij, md)
        m = torch.where(nbh.mask[..., None], mij * eij, 0.0)
        h = h + self.node_mlp(torch.cat([m.sum(dim=2), h], dim=-1))
        if not fix_x:
            g = precision.model_sequential(self.x_mlp, mij, md)[..., 0].to(dist.dtype)
            s = torch.where(nbh.mask, g / (dist + 1.0), 0.0)
            delta = (s[..., None] * rel_x).sum(dim=2)
            x = x + delta * mask_ligand[..., None].to(x.dtype)
        return h, x


class EGNN(nn.Module):
    """The EGNN denoiser (reference: models/egnn.py:67-133): `num_layers`
    EnBaseLayers, each on a graph built from the current coordinates."""

    def __init__(self, num_layers: int, hidden_dim: int, edge_feat_dim: int, k: int = 32,
                 cutoff_mode: str = "knn", max_ligand: int = 0, model_dtype=torch.float32):
        super().__init__()
        if cutoff_mode not in ("knn", "hybrid"):
            raise ValueError(f"Not supported cutoff mode: {cutoff_mode}")
        if cutoff_mode == "hybrid" and max_ligand <= 0:
            raise ValueError("the hybrid graph needs max_ligand > 0")
        if edge_feat_dim != EDGE_TYPES:
            raise ValueError(f"EGNN's edge features are the {EDGE_TYPES} edge types, "
                             f"got edge_feat_dim={edge_feat_dim}")
        self.k, self.cutoff_mode, self.max_ligand = k, cutoff_mode, max_ligand
        self.net = nn.ModuleList([EnBaseLayer(hidden_dim, edge_feat_dim, model_dtype)
                                  for _ in range(num_layers)])

    def graph(self, x, node_mask, mask_ligand) -> G.Neighborhood:
        """The graph on positions x: kNN (the kernel for CUDA tensors) or
        the plain hybrid graph."""
        x = x.detach()
        if self.cutoff_mode == "hybrid":
            return G.hybrid_graph(x, node_mask, mask_ligand, self.k, self.max_ligand)
        return knn_graph(x, node_mask, self.k)

    def forward(self, h, x, mask_ligand, node_mask, fix_x: bool = False):
        for layer in self.net:
            nbh = self.graph(x, node_mask, mask_ligand)
            h, x = layer(h, x, nbh, mask_ligand, G.edge_types(nbh, mask_ligand), fix_x=fix_x)
        return h, x
