"""Binding-affinity models, eager PyTorch, counterpart of
targetdiff_tpu/models/prop/prop_model.py (reference:
models/property_pred/prop_egnn.py:48-83 `EnEquiEncoder`, a residual E(n)-GNN
encoder without coordinate updates over one kNN graph with linspace
distance-RBF edge features; models/property_pred/prop_model.py:28-95
`PropPredNet`, a 3-way Ki/Kd/IC50 head masked by the affinity kind;
:98-215 `PropPredNetEnc`, which injects diffusion-derived features at the
ligand, node or graph level).

The kNN graph is the kNN kernel (ops/kernels/knn.py) for CUDA tensors (its
K-argmin-rounds kernel above K = 32, as the PDBBind config's K = 48) and
its plain version for CPU tensors; the rest is plain PyTorch, as it is XLA
in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from ...ops import graph as G
from ...ops.kernels.knn import knn_graph
from ...ops.rbf import gaussian_smearing
from ..common import MLP, ShiftedSoftplus


class PropBatch(NamedTuple):
    """Dense prop-prediction batch; `kind` in {1: Ki, 2: Kd, 3: IC50}."""

    protein_pos: torch.Tensor  # [B, NP, 3]
    protein_feat: torch.Tensor  # [B, NP, FP]
    protein_mask: torch.Tensor  # [B, NP] bool
    ligand_pos: torch.Tensor  # [B, NL, 3]
    ligand_feat: torch.Tensor  # [B, NL, FL]
    ligand_mask: torch.Tensor  # [B, NL] bool
    y: torch.Tensor  # [B]
    kind: torch.Tensor  # [B] int64 (1..3)
    enc_ligand_feat: Optional[torch.Tensor] = None  # [B, NL, D1]
    enc_node_feat: Optional[torch.Tensor] = None  # [B, NP + NL, D2]
    enc_graph_feat: Optional[torch.Tensor] = None  # [B, D3]

    @property
    def num_graphs(self) -> int:
        return self.protein_pos.shape[0]

    def to(self, device) -> "PropBatch":
        return PropBatch(*[None if t is None else t.to(device) for t in self])


class EnBaseLayerProp(nn.Module):
    """(reference: models/property_pred/prop_egnn.py:8-46): message MLP with
    a sigmoid gate, summed over the neighbours, then the node MLP; returns
    the residual branch."""

    def __init__(self, hidden_dim: int, edge_dim: int, act_fn: str = "relu", norm: bool = False):
        super().__init__()
        self.edge_mlp = MLP(edge_dim + 2 * hidden_dim, hidden_dim, hidden_dim, num_layer=2,
                            norm=norm, act_fn=act_fn, act_last=True)
        self.edge_inf = nn.Sequential(nn.Linear(hidden_dim, 1), nn.Sigmoid())
        self.node_mlp = MLP(2 * hidden_dim, hidden_dim, hidden_dim, num_layer=2, norm=norm,
                            act_fn=act_fn)

    def forward(self, h, nbh: G.Neighborhood, edge_attr):
        B, N, H = h.shape
        K = nbh.idx.shape[-1]
        mij = self.edge_mlp(torch.cat(
            [edge_attr, h[:, :, None, :].expand(B, N, K, H), G.gather_nodes(h, nbh.idx)], dim=-1))
        m = torch.where(nbh.mask[..., None], mij * self.edge_inf(mij), 0.0)
        return self.node_mlp(torch.cat([m.sum(dim=2), h], dim=-1))


class EnEquiEncoder(nn.Module):
    """(reference: models/property_pred/prop_egnn.py:48-83): one kNN graph
    on the input positions, `num_r_gaussian` RBF knots over [0, cutoff],
    `num_layers` residual EnBaseLayerProp updates of h."""

    def __init__(self, num_layers: int, hidden_dim: int, num_r_gaussian: int, k: int = 32,
                 cutoff: float = 10.0, act_fn: str = "relu", norm: bool = False):
        super().__init__()
        self.k = k
        knots = np.linspace(0.0, cutoff, num_r_gaussian)
        self.register_buffer("offsets", torch.tensor(knots, dtype=torch.float32),
                             persistent=False)
        self.coeff = -0.5 / float(knots[1] - knots[0]) ** 2
        self.net = nn.ModuleList([EnBaseLayerProp(hidden_dim, num_r_gaussian, act_fn=act_fn,
                                                  norm=norm) for _ in range(num_layers)])

    def forward(self, node_attr, pos, node_mask):
        nbh = knn_graph(pos.detach(), node_mask, self.k)
        _, dist = G.rel_geometry(pos, nbh)
        edge_attr = gaussian_smearing(dist, self.offsets, self.coeff)
        h = node_attr
        for layer in self.net:
            h = h + layer(h, nbh, edge_attr)
        return h


def encoder_from_config(cfg) -> EnEquiEncoder:
    if cfg.name not in ("egnn", "egnn_enc"):
        raise ValueError(cfg.name)
    return EnEquiEncoder(num_layers=cfg.num_layers, hidden_dim=cfg.hidden_dim,
                         num_r_gaussian=cfg.num_r_gaussian, k=cfg.knn, cutoff=cfg.cutoff,
                         act_fn=cfg.act_fn, norm=cfg.norm)


def _kind_select(out: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """out [B, 3] -> [B], the column of each complex's kind (1..3); a kind
    outside 1..3 selects nothing (0), as JAX's one_hot gives."""
    cols = torch.arange(out.shape[-1], device=out.device)
    return (out * ((kind.long() - 1)[:, None] == cols).to(out.dtype)).sum(-1)


class PropPredNet(nn.Module):
    """(reference: models/property_pred/prop_model.py:28-95): embeddings,
    the encoder over the composed protein | ligand context, sum pooling,
    Linear -> shifted softplus -> Linear to `output_dim` heads, the head of
    each complex's kind selected."""

    def __init__(self, config, protein_atom_feature_dim: int, ligand_atom_feature_dim: int,
                 output_dim: int = 3):
        super().__init__()
        hidden = config.hidden_channels
        self.output_dim = output_dim
        self.protein_atom_emb = nn.Linear(protein_atom_feature_dim, hidden)
        self.ligand_atom_emb = nn.Linear(ligand_atom_feature_dim, hidden)
        self.encoder = encoder_from_config(config.encoder)
        self.out = nn.Sequential(nn.Linear(hidden, hidden), ShiftedSoftplus(),
                                 nn.Linear(hidden, output_dim))

    def forward(self, batch: PropBatch) -> torch.Tensor:
        h, pos, mask_all, _ = G.compose_context(
            self.protein_atom_emb(batch.protein_feat), self.ligand_atom_emb(batch.ligand_feat),
            batch.protein_pos, batch.ligand_pos, batch.protein_mask, batch.ligand_mask)
        h = self.encoder(h, pos, mask_all)
        out = self.out((h * mask_all[..., None].to(h.dtype)).sum(dim=1))
        return _kind_select(out, batch.kind)


class PropPredNetEnc(nn.Module):
    """The encoder variant with injected diffusion features (reference:
    models/property_pred/prop_model.py:98-215): enc_ligand_feat joins the
    ligand features, enc_node_feat the encoder's output (then Linear -> ReLU
    -> Linear back to the hidden width), enc_graph_feat the pooled vector.
    One head unless output_dim > 1."""

    def __init__(self, config, protein_atom_feature_dim: int, ligand_atom_feature_dim: int,
                 enc_ligand_dim: int = 0, enc_node_dim: int = 0, enc_graph_dim: int = 0,
                 output_dim: int = 1):
        super().__init__()
        hidden = config.hidden_channels
        self.enc_ligand_dim, self.enc_node_dim = enc_ligand_dim, enc_node_dim
        self.enc_graph_dim, self.output_dim = enc_graph_dim, output_dim
        self.protein_atom_emb = nn.Linear(protein_atom_feature_dim, hidden)
        self.ligand_atom_emb = nn.Linear(ligand_atom_feature_dim + enc_ligand_dim, hidden)
        self.encoder = encoder_from_config(config.encoder)
        if enc_node_dim > 0:
            self.enc_node = nn.Sequential(nn.Linear(hidden + enc_node_dim, hidden), nn.ReLU(),
                                          nn.Linear(hidden, hidden))
        self.out = nn.Sequential(nn.Linear(hidden + enc_graph_dim, hidden), ShiftedSoftplus(),
                                 nn.Linear(hidden, output_dim))

    def forward(self, batch: PropBatch) -> torch.Tensor:
        lig_feat = batch.ligand_feat
        if self.enc_ligand_dim > 0:
            lig_feat = torch.cat([lig_feat, batch.enc_ligand_feat], dim=-1)
        h, pos, mask_all, _ = G.compose_context(
            self.protein_atom_emb(batch.protein_feat), self.ligand_atom_emb(lig_feat),
            batch.protein_pos, batch.ligand_pos, batch.protein_mask, batch.ligand_mask)
        h = self.encoder(h, pos, mask_all)
        if self.enc_node_dim > 0:
            h = self.enc_node(torch.cat([h, batch.enc_node_feat], dim=-1))
        pre_out = (h * mask_all[..., None].to(h.dtype)).sum(dim=1)
        if self.enc_graph_dim > 0:
            pre_out = torch.cat([pre_out, batch.enc_graph_feat], dim=-1)
        out = self.out(pre_out)
        if self.output_dim > 1:
            return _kind_select(out, batch.kind)
        return out[..., 0]


def prop_loss_fn(model: nn.Module, batch: PropBatch, pos_noise_std: float,
                 generator: Optional[torch.Generator] = None, noise=None):
    """MSE with coordinate-noise augmentation (reference:
    models/property_pred/prop_model.py:76-95). `noise` = (protein [B,NP,3],
    ligand [B,NL,3]) standard normal may be given; else it is drawn from
    `generator`. Returns (loss, pred)."""
    if noise is None:
        dev = batch.protein_pos.device
        noise = (torch.randn(batch.protein_pos.shape, generator=generator, device=dev),
                 torch.randn(batch.ligand_pos.shape, generator=generator, device=dev))
    pnoise, lnoise = noise
    noisy = batch._replace(protein_pos=batch.protein_pos + pnoise * pos_noise_std,
                           ligand_pos=batch.ligand_pos + lnoise * pos_noise_std)
    pred = model(noisy)
    return ((pred - batch.y) ** 2).mean(), pred
