"""Dense padded graph ops, counterpart of targetdiff_tpu/ops/graph.py.

Each complex is a padded node set [B, N, ...] with a validity mask [B, N];
neighborhoods are [B, N, K] source indices per destination row with a
neighbor mask (torch_cluster `knn_graph`, flow='source_to_target').
`knn_graph` here is the plain version of the kNN kernel
(ops/kernels/knn.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

BIG = 1e20


class Neighborhood(NamedTuple):
    idx: torch.Tensor  # [B, N, K] int64 source-node indices per destination row
    mask: torch.Tensor  # [B, N, K] bool neighbor validity


def pairwise_sq_dists(pos: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] -> [B, N, N] squared distances by the matmul identity,
    clipped at 0; used for neighbor selection only."""
    sq = (pos * pos).sum(-1)
    cross = torch.bmm(pos, pos.transpose(1, 2))
    return torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * cross, min=0.0)


def knn_graph(pos: torch.Tensor, mask: torch.Tensor, k: int) -> Neighborhood:
    """k nearest valid neighbors j != i of every row i, nearest first; ties
    go to the lower index (a stable sort, as the kernel's first-index
    argmin). Padded rows get fully masked neighborhoods whose indices still
    lie in [0, N)."""
    N = pos.shape[1]
    if k > N:
        raise ValueError(f"k={k} exceeds the {N} nodes per complex")
    valid = mask[:, None, :] & mask[:, :, None] & ~torch.eye(N, dtype=torch.bool, device=pos.device)
    d2 = torch.where(valid, pairwise_sq_dists(pos), torch.full((), BIG, device=pos.device))
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return Neighborhood(idx=idx[..., :k], mask=vals[..., :k] < BIG / 2)


def edge_types(nbh: Neighborhood, mask_ligand: torch.Tensor) -> torch.Tensor:
    """4-way one-hot edge type by (src is ligand, dst is ligand)
    (reference: models/uni_transformer.py:288-299): 0 l->l, 1 l->p, 2 p->l,
    3 p->p. Returns [B, N, K, 4] float32."""
    src_lig = torch.gather(mask_ligand[:, None, :].expand(-1, nbh.idx.shape[1], -1), 2, nbh.idx)
    dst_lig = mask_ligand[:, :, None]
    etype = torch.where(src_lig & dst_lig, 0,
                        torch.where(src_lig & ~dst_lig, 1, torch.where(~src_lig & dst_lig, 2, 3)))
    return F.one_hot(etype, 4).float()


def gather_nodes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, D], idx [B, N, K] -> [B, N, K, D]."""
    B, N, K = idx.shape
    flat = torch.gather(x, 1, idx.reshape(B, N * K, 1).expand(-1, -1, x.shape[-1]))
    return flat.reshape(B, N, K, x.shape[-1])


def rel_geometry(x: torch.Tensor, nbh: Neighborhood):
    """rel [B, N, K, 3] = x_dst - x_src and dist [B, N, K]."""
    rel = x[:, :, None, :] - gather_nodes(x, nbh.idx)
    return rel, torch.sqrt((rel * rel).sum(-1) + 1e-16)


def compose_context(h_protein, h_ligand, pos_protein, pos_ligand, protein_mask, ligand_mask):
    """Protein rows then ligand rows in one padded context. Returns
    (h [B,N,H], pos [B,N,3], node_mask [B,N], mask_ligand [B,N]); padded
    ligand slots are not ligand."""
    B, NP = protein_mask.shape
    NL = ligand_mask.shape[1]
    mask_all = torch.cat([protein_mask, ligand_mask], dim=1)
    mask_ligand = torch.cat(
        [torch.zeros((B, NP), dtype=torch.bool, device=mask_all.device),
         torch.ones((B, NL), dtype=torch.bool, device=mask_all.device)], dim=1
    ) & mask_all
    return (torch.cat([h_protein, h_ligand], dim=1), torch.cat([pos_protein, pos_ligand], dim=1),
            mask_all, mask_ligand)
