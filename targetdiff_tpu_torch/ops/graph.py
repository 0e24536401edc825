"""Dense padded graph ops, counterpart of targetdiff_tpu/ops/graph.py.

Each complex is a padded node set [B, N, ...] with a validity mask [B, N];
neighborhoods are [B, N, K] source indices per destination row with a
neighbor mask (torch_cluster `knn_graph`, flow='source_to_target').
`knn_graph` here is the plain version of the kNN kernel
(ops/kernels/knn.py); `hybrid_graph` is plain PyTorch on every device, as
it is XLA in the JAX package.
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
    return _nearest(pairwise_sq_dists(pos), mask, k)


def _nearest(d2: torch.Tensor, mask: torch.Tensor, k: int) -> Neighborhood:
    """The k first of a stable sort of each row of d2 [B, N, N], invalid and
    self pairs at BIG."""
    N = d2.shape[1]
    if k > N:
        raise ValueError(f"k={k} exceeds the {N} nodes per complex")
    valid = mask[:, None, :] & mask[:, :, None] & ~torch.eye(N, dtype=torch.bool, device=d2.device)
    d2 = torch.where(valid, d2, torch.full((), BIG, device=d2.device))
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return Neighborhood(idx=idx[..., :k], mask=vals[..., :k] < BIG / 2)


def knn_graph_exact(pos: torch.Tensor, mask: torch.Tensor, k: int) -> Neighborhood:
    """knn_graph with the kNN kernel's own rounding (csrc/knn.cu): every
    squared distance from float32 elementwise operations in the kernel's
    order, |p_i|^2 = (x x + y y) + z z, cross = (x_i x_j + y_i y_j) + z_i z_j,
    d2 = max((|p_i|^2 + |p_j|^2) - 2 cross, 0), each operation rounded on
    its own (no product reduction, no fused multiply-add), then the same
    stable sort. Its idx and mask equal the kernel's bit for bit; for tests
    and chip_smoke.py (the main path's CPU route keeps knn_graph)."""
    x, y, z = pos.unbind(-1)
    sq = (x * x + y * y) + z * z
    cross = ((x[:, :, None] * x[:, None, :] + y[:, :, None] * y[:, None, :])
             + z[:, :, None] * z[:, None, :])
    return _nearest(torch.clamp((sq[:, :, None] + sq[:, None, :]) - 2.0 * cross, min=0.0),
                    mask, k)


def hybrid_graph(pos: torch.Tensor, node_mask: torch.Tensor, mask_ligand: torch.Tensor, k: int,
                 max_ligand: int) -> Neighborhood:
    """Hybrid connectivity (reference: models/common.py:165-212): a ligand
    row connects to every other ligand atom and its k nearest protein atoms,
    a protein row to its k nearest atoms. Dense form of width
    K = max_ligand - 1 + k, valid slots first, nearest first; ties go to the
    lower index (a stable sort, as lax.top_k does in the JAX package), so
    both packages pick the same neighbours. mask_ligand [B, N] is True on
    real ligand rows."""
    B, N, _ = pos.shape
    K = max_ligand - 1 + k
    if K > N:
        raise ValueError(f"hybrid K = max_ligand - 1 + k = {K} exceeds the {N} nodes per complex")
    big = torch.full((), BIG, device=pos.device)
    d2 = pairwise_sq_dists(pos)
    valid = node_mask[:, None, :] & node_mask[:, :, None] & ~torch.eye(
        N, dtype=torch.bool, device=pos.device)
    lig_src = mask_ligand[:, None, :].expand(B, N, N)
    # ligand rows: every ligand source ranks ahead of the protein ones (the
    # +1e6 offset exceeds any real squared distance); keep them all plus the
    # k nearest protein sources
    vals_l, idx_l = torch.sort(torch.where(valid, torch.where(lig_src, d2, d2 + 1e6), big),
                               dim=-1, stable=True)
    vals_l, idx_l = vals_l[..., :K], idx_l[..., :K]
    src_is_lig = torch.gather(lig_src, 2, idx_l)
    protein_rank = torch.cumsum((~src_is_lig).to(torch.int32), dim=-1)
    keep_l = (vals_l < BIG / 2) & (src_is_lig | (protein_rank <= k))
    # protein rows: the first k valid of a plain nearest-first order
    vals_p, idx_p = torch.sort(torch.where(valid, d2, big), dim=-1, stable=True)
    vals_p, idx_p = vals_p[..., :K], idx_p[..., :K]
    keep_p = vals_p < BIG / 2
    keep_p = keep_p & (torch.cumsum(keep_p.to(torch.int32), dim=-1) <= k)
    lig_dst = mask_ligand[:, :, None]
    return Neighborhood(idx=torch.where(lig_dst, idx_l, idx_p),
                        mask=torch.where(lig_dst, keep_l, keep_p))


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
