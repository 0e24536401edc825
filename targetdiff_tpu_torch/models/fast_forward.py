"""Kernel-backed forward passes, counterpart of targetdiff_tpu/models/fast_forward.py.

`fast_forward` (inference) and `fast_train_forward` (differentiable) compute
what `ScorePosNet.forward` computes, with the graph and the UniTransformerO2
layers running on the hand-written CUDA kernels for CUDA tensors
(ops/kernels/) and on their plain PyTorch versions for CPU tensors. The kNN
graph is a kernel; the hybrid graph is plain PyTorch, as it is XLA in the
JAX package. A block runs either on the whole-block kernels (K <= 32) or on
the per-layer kernels, whose edge weights come from the eager edge-weight
MLP. With need_full_h=False (the sampler's, as in the JAX package) the last
block runs on the dependency cone of the ligand outputs (ops/kernels/
cone.py): each layer computes only the rows a ligand output can still
reach, so `final_h` comes back stale on the other (protein) rows and the
ligand outputs as with every row live, bit for bit. The cone is the JAX
package's per-layer tile flags at the granularity of rows; the port neither
sorts protein rows nor keeps tiles, which exist there to make TPU tiles
skippable. Both take the products'
precision, `dtype`, float32 by default here: the sampler's default is bf16,
as in the JAX package, and `fast_train_forward(dtype=torch.bfloat16)` is
its bf16 training variant (`get_diffusion_loss(impl='fast_bf16' |
'fast_bf16_pl')`: bf16 products in both directions, the edge-weight MLP,
the activations between layers and every gradient float32).
"""

from __future__ import annotations

import logging
import warnings
from typing import Dict, Optional

import torch

from ..config import Config
from ..ops.kernels.block_denoiser import MAX_K, PackedBlock, block_denoiser, pack_block_params
from ..ops.kernels.block_vjp import block_layers_trainable
from ..ops.kernels.cone import ConeWorkspace, block_cone
from ..ops.kernels.edge_layer import h2x_attention_layer, x2h_attention_layer
from ..ops.kernels.edge_layer_vjp import h2x_layer_trainable, x2h_layer_trainable
from ..ops.kernels.knn import knn_graph
from ..ops.precision import check_dtype
from ..ops.rbf import FIXED_OFFSETS
from .common import ACTIVATIONS
from .uni_transformer import EDGE_TYPES, EW_NET_TYPES


def fast_forward_supported(config: Config) -> tuple:
    """Whether the port supports this model config: the released TargetDiff
    architecture (reference: configs/training.yml:9-42) over a kNN or a
    hybrid graph. Returns (ok, reason)."""
    cfg = config
    checks = [
        (cfg.model_type == "uni_o2", f"model_type={cfg.model_type!r} (need uni_o2)"),
        (cfg.cutoff_mode in ("knn", "hybrid"), f"cutoff_mode={cfg.cutoff_mode!r}"),
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


def eager_supported(config: Config) -> tuple:
    """Whether the port's eager network builds this config: every uni_o2
    and EGNN configuration the JAX package's XLA path builds
    (targetdiff_tpu/models/uni_transformer.py, egnn.py, score_model.py),
    over a kNN or a hybrid graph, with or without a time embedding. Refused,
    as there: `cutoff_mode` other than knn / hybrid (JAX raises), a
    `time_emb_mode` other than simple / sin, an unknown activation or edge-
    weight type. Also refused: uni_o2 with `num_r_gaussian` other than 20,
    since JAX and the reference smear distances on the 20 fixed knots
    whatever it says (targetdiff_tpu/ops/rbf.py:21-31) and the reference's
    MLP widths then break, and with nonzero `edge_feat_dim` other than 4,
    the width of the edge-type one-hot that feeds the attention. Returns
    (ok, reason)."""
    cfg = config
    temb = cfg.get("time_emb_dim", 0)
    checks = [
        (cfg.model_type in ("uni_o2", "egnn"), f"model_type={cfg.model_type!r}"),
        (cfg.cutoff_mode in ("knn", "hybrid"), f"cutoff_mode={cfg.cutoff_mode!r}"),
        (temb == 0 or cfg.get("time_emb_mode", "simple") in ("simple", "sin"),
         f"time_emb_mode={cfg.get('time_emb_mode')!r} (have 'simple', 'sin')"),
    ]
    if cfg.model_type == "uni_o2":
        checks += [
            (cfg.ew_net_type in EW_NET_TYPES,
             f"ew_net_type={cfg.ew_net_type!r} (have {', '.join(EW_NET_TYPES)})"),
            (cfg.act_fn in ACTIVATIONS, f"act_fn={cfg.act_fn!r} (have {', '.join(ACTIVATIONS)})"),
            (cfg.num_x2h >= 0 and cfg.num_h2x >= 0,
             f"num_x2h={cfg.num_x2h}/num_h2x={cfg.num_h2x}"),
            (cfg.edge_feat_dim in (0, EDGE_TYPES),
             f"edge_feat_dim={cfg.edge_feat_dim} (the edge features are the {EDGE_TYPES} "
             "edge types, or none)"),
            (cfg.num_r_gaussian == len(FIXED_OFFSETS),
             f"num_r_gaussian={cfg.num_r_gaussian} (need {len(FIXED_OFFSETS)}, the fixed knots)"),
        ]
    for ok, reason in checks:
        if not ok:
            return False, reason
    return True, ""


def require_kernels(config: Config) -> None:
    """Raise ValueError, with the reason, unless the kernel paths take this
    config."""
    ok, reason = fast_forward_supported(config)
    if not ok:
        raise ValueError(f"impl='fast' runs the released uni_o2 architecture on the kernels; "
                         f"this config has {reason}: use impl='eager'")


def require_float32_model(net) -> None:
    """Raise ValueError unless `net` (a ScorePosNet) is a float32 model: the
    kernels take their precision from `dtype`, never from the model dtype."""
    if net.model_dtype != torch.float32:
        raise ValueError(f"the kernel paths run float32 models (their products' precision "
                         f"is dtype=); this model's dtype is {net.model_dtype}: use impl='eager'")


def resolve_impl(config: Config, model_dtype=torch.float32) -> str:
    """The denoiser's path for this config, chosen once by the model (the
    port's counterpart of targetdiff_tpu/models/fast_forward.py:195 'auto'):
    'fast' (the kernels) when the config is supported and the model is
    float32, else 'eager' (a bf16 model runs eagerly, as the JAX package's
    dtype=bf16 model on its XLA path). The choice depends on the config and
    the model dtype alone, never on the device or on a failed build; it is
    logged with the option that sends the config to the eager path."""
    ok, reason = fast_forward_supported(config)
    if ok and model_dtype != torch.float32:
        ok, reason = False, f"model_dtype={model_dtype}"
    logging.getLogger(__name__).info(
        "denoiser path: %s",
        "the kernels (fast)" if ok else f"eager ({reason} is not on the kernels)")
    return "fast" if ok else "eager"


def _graph(rn, x, node_mask, mask_ligand):
    """The block's graph: the kNN kernel, or the plain hybrid graph."""
    if rn.cutoff_mode == "hybrid":
        return rn.graph(x, node_mask, mask_ligand)
    return knn_graph(x, node_mask, rn.k)


def fast_forward(net, protein_pos, protein_feat, protein_mask, ligand_pos, ligand_v,
                 ligand_mask, packed: Optional[PackedBlock] = None,
                 mode: str = "mega", fix_x: bool = False,
                 dtype=torch.float32, need_full_h: bool = True,
                 cone_workspace: Optional[ConeWorkspace] = None) -> Dict[str, torch.Tensor]:
    """`net` is a ScorePosNet; `packed` its refine_net's kernel weights
    for `dtype` (packed on the fly when None). mode 'mega' runs each block on the
    whole-block kernels, 'layers' on the per-layer kernels; a graph wider
    than the block kernels take (K > 32, as the hybrid graph at the CLI's
    64 ligand slots) runs on the per-layer kernels with a warning, as the
    JAX package does. fix_x=True freezes the coordinates (the embedding
    export): neither route runs the h2x pass. dtype: the attention layers'
    products, torch.float32 or torch.bfloat16 (targetdiff_tpu/models/
    fast_forward.py's dtype); in 'mega' mode the edge-weight MLP too, in
    'layers' mode it stays the float32 eager MLP, as the JAX package's
    layers mode. need_full_h=False (sampling, likelihood): the last block in
    'mega' mode, unless fix_x, computes each layer on its dependency cone
    (one `cone_kernel` call, then row lists), as the JAX package's
    need_full_h=False: only the ligand outputs are valid, the protein rows
    of `final_h` are STALE; `cone_workspace` (a run's `ConeWorkspace`) holds
    the cone, else it is allocated. Returns pred_ligand_pos, pred_ligand_v,
    final_ligand_h and final_h."""
    if mode not in ("mega", "layers"):
        raise ValueError(f"mode must be 'mega' or 'layers', got {mode!r}")
    check_dtype(dtype)
    require_kernels(net.config)
    require_float32_model(net)
    if packed is not None and packed.dtype != dtype:
        raise ValueError(f"packed weights are for {packed.dtype} kernels, not {dtype}")
    h, x, node_mask, mask_ligand = net.embed(
        protein_pos, protein_feat, protein_mask, ligand_pos, ligand_v, ligand_mask)
    rn = net.refine_net
    n_ligand = ligand_pos.shape[1]
    K = rn.num_neighbors()
    if mode == "mega" and K > MAX_K:
        warnings.warn(f"the whole-block kernels take K <= {MAX_K}, this graph has K={K}: "
                      "running the per-layer kernels (mode='layers')", stacklevel=2)
        mode = "layers"
    if mode == "layers" and packed is None and h.device.type != "cpu":
        with torch.no_grad():
            packed = pack_block_params(rn, dtype)
    for b in range(rn.num_blocks):
        nbh = _graph(rn, x, node_mask, mask_ligand)
        if mode == "mega":
            # h between blocks feeds the next block in full: the cone is the
            # last block's
            cone = None
            if not need_full_h and not fix_x and b == rn.num_blocks - 1:
                cone = block_cone(nbh.idx, nbh.mask, n_ligand, len(rn.base_block),
                                  cone_workspace)
            h, x = block_denoiser(rn, h, x, nbh, mask_ligand, n_ligand=n_ligand, packed=packed,
                                  fix_x=fix_x, dtype=dtype, cone=cone)
            continue
        e_w = rn.edge_weights(x, nbh)[..., 0]
        for l, layer in enumerate(rn.base_block):
            px = ph = None
            if packed is not None:
                px = {f: t[l:l + 1] for f, t in packed.x2h.items()}
                ph = {f: t[l:l + 1] for f, t in packed.h2x.items()}
            h = x2h_attention_layer(layer, h, x, nbh, mask_ligand, e_w, params=px, dtype=dtype)
            if not fix_x:
                x = h2x_attention_layer(layer, h, x, nbh, mask_ligand, e_w, n_ligand, params=ph,
                                        dtype=dtype)
    return net.head(h, x, ligand_mask, protein_pos.shape[1])


def fast_train_forward(net, protein_pos, protein_feat, protein_mask, ligand_pos, ligand_v,
                       ligand_mask, whole_block_bwd: bool = True,
                       dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Differentiable kernel-backed forward (training). The embeddings, the
    graph (integer indices, no gradient), the eager global edge-weight MLP
    and the v_inference head surround the attention layers.
    whole_block_bwd=True runs each block as `block_layers_trainable`, whose
    backward is the block-VJP kernel; False runs the per-layer trainables
    (forward and backward per-layer kernels), as does a graph wider than the
    block kernels take (K > 32), with a warning. dtype: the attention
    layers' products in both directions (targetdiff_tpu/models/
    fast_forward.py fast_train_forward's dtype); the edge-weight MLP stays
    float32 and autograd-differentiated in both. Returns pred_ligand_pos,
    pred_ligand_v, final_ligand_h (padded ligand rows zero) and final_h."""
    check_dtype(dtype)
    require_kernels(net.config)
    require_float32_model(net)
    h, x, node_mask, mask_ligand = net.embed(
        protein_pos, protein_feat, protein_mask, ligand_pos, ligand_v, ligand_mask)
    rn = net.refine_net
    n_ligand = ligand_pos.shape[1]
    K = rn.num_neighbors()
    if whole_block_bwd and K > MAX_K:
        warnings.warn(f"the whole-block kernels take K <= {MAX_K}, this graph has K={K}: "
                      "training on the per-layer kernels and their backwards", stacklevel=2)
        whole_block_bwd = False
    for _ in range(rn.num_blocks):
        nbh = _graph(rn, x.detach(), node_mask, mask_ligand)
        e_w = rn.edge_weights(x, nbh)[..., 0]
        if whole_block_bwd:
            h, x = block_layers_trainable(rn, h, x, nbh, mask_ligand, e_w, n_ligand=n_ligand,
                                          dtype=dtype)
            continue
        for layer in rn.base_block:
            h = x2h_layer_trainable(layer, h, x, nbh, mask_ligand, e_w, dtype)
            x = h2x_layer_trainable(layer, h, x, nbh, mask_ligand, e_w, n_ligand, dtype)
    return net.head(h, x, ligand_mask, protein_pos.shape[1])
