"""Kernel-backed forward passes, counterpart of targetdiff_tpu/models/fast_forward.py.

`fast_forward` (inference) and `fast_train_forward` (differentiable) compute
what `ScorePosNet.forward` computes, with the kNN graph and the whole
UniTransformerO2 block running on the hand-written CUDA kernels for CUDA
tensors (ops/kernels/) and on their plain PyTorch versions for CPU tensors.
Unlike the JAX fast paths they neither sort protein rows nor skip tiles:
every row of every layer is computed.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import Config
from ..ops.kernels.block_denoiser import PackedBlock, block_denoiser
from ..ops.kernels.block_vjp import block_layers_trainable
from ..ops.kernels.knn import knn_graph
from ..ops.rbf import FIXED_OFFSETS


def fast_forward_supported(config: Config) -> tuple:
    """Whether the port supports this model config: the released TargetDiff
    architecture (reference: configs/training.yml:9-42). Returns (ok, reason)."""
    cfg = config
    checks = [
        (cfg.model_type == "uni_o2", f"model_type={cfg.model_type!r} (need uni_o2)"),
        (cfg.cutoff_mode == "knn", f"cutoff_mode={cfg.cutoff_mode!r} (need knn)"),
        (cfg.ew_net_type == "global", f"ew_net_type={cfg.ew_net_type!r}"),
        (not cfg.x2h_out_fc, "x2h_out_fc=True"),
        (cfg.num_x2h == 1 and cfg.num_h2x == 1,
         f"num_x2h={cfg.num_x2h}/num_h2x={cfg.num_h2x} (need 1/1)"),
        (not cfg.sync_twoup, "sync_twoup=True"),
        (cfg.get("time_emb_dim", 0) == 0, "time_emb_dim>0"),
        (cfg.act_fn == "relu", f"act_fn={cfg.act_fn!r}"),
        (bool(cfg.norm), "norm=False"),
        (cfg.edge_feat_dim == 4, f"edge_feat_dim={cfg.edge_feat_dim} (need 4)"),
        (cfg.num_r_gaussian == len(FIXED_OFFSETS),
         f"num_r_gaussian={cfg.num_r_gaussian} (need {len(FIXED_OFFSETS)}, the fixed knots)"),
    ]
    for ok, reason in checks:
        if not ok:
            return False, reason
    return True, ""


def fast_forward(net, protein_pos, protein_feat, protein_mask, ligand_pos, ligand_v,
                 ligand_mask, packed: Optional[PackedBlock] = None) -> Dict[str, torch.Tensor]:
    """`net` is a ScorePosNet; `packed` its refine_net's kernel weights
    (packed on the fly when None). Returns pred_ligand_pos, pred_ligand_v,
    final_ligand_h and final_h."""
    h, x, node_mask, mask_ligand = net.embed(
        protein_pos, protein_feat, protein_mask, ligand_pos, ligand_v, ligand_mask)
    rn = net.refine_net
    for _ in range(rn.num_blocks):
        nbh = knn_graph(x, node_mask, rn.k)
        h, x = block_denoiser(rn, h, x, nbh, mask_ligand, n_ligand=ligand_pos.shape[1],
                              packed=packed)
    return net.head(h, x, ligand_mask, protein_pos.shape[1])


def fast_train_forward(net, protein_pos, protein_feat, protein_mask, ligand_pos, ligand_v,
                       ligand_mask) -> Dict[str, torch.Tensor]:
    """Differentiable kernel-backed forward (training). The embeddings, the
    kNN kernel (integer indices, no gradient), the edge types, the eager
    global edge-weight MLP and the v_inference head surround
    `block_layers_trainable`, whose backward is the block-VJP kernel.
    Returns pred_ligand_pos, pred_ligand_v, final_ligand_h (padded ligand
    rows zero) and final_h."""
    h, x, node_mask, mask_ligand = net.embed(
        protein_pos, protein_feat, protein_mask, ligand_pos, ligand_v, ligand_mask)
    rn = net.refine_net
    for _ in range(rn.num_blocks):
        nbh = knn_graph(x.detach(), node_mask, rn.k)
        e_w = rn.edge_weights(x, nbh)[..., 0]
        h, x = block_layers_trainable(rn, h, x, nbh, mask_ligand, e_w,
                                      n_ligand=ligand_pos.shape[1])
    return net.head(h, x, ligand_mask, protein_pos.shape[1])
