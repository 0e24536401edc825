"""ScorePosNet and the DDPM sampler, counterpart of
targetdiff_tpu/models/score_model.py (reference:
models/molopt_score_model.py:198-703).

`ScorePosNet` is the network (atom embeddings, node indicator, refine net,
v_inference head) with the reference's parameter names. `DiffusionModel`
owns it and the schedules; `get_diffusion_loss` is the training loss (its
draws injectable as tensors), `likelihood_estimation` the per-timestep ELBO
terms, `fetch_embedding` the hidden states with frozen coordinates,
`sample_step` is one pure reverse step (ddpm, ddim or dpm2) that takes its
noise as arguments, and `sample_diffusion` loops over the jumps of
`sampling_schedule` drawing that noise from a `torch.Generator`.

Precision, as the JAX package: `fast_apply`, `sample_step` and
`sample_diffusion` take `dtype`, the kernels' products, torch.bfloat16 by
default (the JAX package's sampling default) or torch.float32; impl='eager'
ignores it. `likelihood_estimation` and `fetch_embedding` run in float32
whatever the sampler's default; training is float32 unless
`get_diffusion_loss` is given impl='fast_bf16' or 'fast_bf16_pl' (the JAX
package's bf16 training variant). Apart from these, `DiffusionModel(
model_dtype=torch.bfloat16)` is the JAX package's bf16 model (its
`DiffusionModel(dtype=jnp.bfloat16)`), which runs eagerly in every entry
point.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import Config
from ..data.batch import ComplexBatch
from ..ops import diffusion as D
from ..ops import graph as G
from ..ops import precision
from ..ops.kernels.block_denoiser import PackedBlock, pack_block_params
from ..ops.kernels.cone import ConeWorkspace
from ..ops.precision import check_dtype
from ..ops.schedules import make_categorical_schedule, make_gaussian_schedule
from .common import ShiftedSoftplus
from .egnn import EGNN
from .fast_forward import (eager_supported, fast_forward, fast_forward_supported,
                           fast_train_forward, require_kernels, resolve_impl)
from .uni_transformer import UniTransformerO2TwoUpdateGeneral

# get_diffusion_loss's denoiser paths: float32 ('fast', 'fast_pl', 'eager')
# and the bf16 training variant of the first two (JAX's names)
TRAIN_IMPLS = ("fast", "fast_pl", "eager", "fast_bf16", "fast_bf16_pl")


class SinusoidalPosEmb(nn.Module):
    """Sinusoidal features of a time step [B] -> [B, dim] (reference:
    models/molopt_score_model.py:182-194; targetdiff_tpu/models/
    score_model.py:45-55)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        half_dim = self.dim // 2
        emb = math.log(10000) / (half_dim - 1)
        emb = torch.exp(torch.arange(half_dim, device=x.device, dtype=torch.float32) * -emb)
        emb = x[:, None] * emb[None, :]
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


def build_refine_net(config: Config, max_ligand: int, model_dtype=torch.float32) -> nn.Module:
    """The refine net of `model_type` (targetdiff_tpu/models/score_model.py:
    58): uni_o2 with every option of the config, or the EGNN denoiser, which
    takes neither the config's RBF knots nor its activation and norm (one
    distance feature, silu, no norm), as the JAX package builds it. A uni_o2
    net that is not the kernels' plain version (another architecture, or a
    bf16 model) builds its kNN graph on the kNN kernel."""
    if config.model_type == "egnn":
        return EGNN(num_layers=config.num_layers, hidden_dim=config.hidden_dim,
                    edge_feat_dim=config.edge_feat_dim, k=config.knn,
                    cutoff_mode=config.cutoff_mode, max_ligand=max_ligand,
                    model_dtype=model_dtype)
    kernels, _ = fast_forward_supported(config)
    return UniTransformerO2TwoUpdateGeneral(
        num_blocks=config.num_blocks, num_layers=config.num_layers,
        hidden_dim=config.hidden_dim, n_heads=config.n_heads, k=config.knn,
        num_r_gaussian=config.num_r_gaussian, edge_feat_dim=config.edge_feat_dim,
        cutoff_mode=config.cutoff_mode, max_ligand=max_ligand, act_fn=config.act_fn,
        norm=bool(config.norm), ew_net_type=config.ew_net_type, num_x2h=config.num_x2h,
        num_h2x=config.num_h2x, x2h_out_fc=bool(config.x2h_out_fc),
        sync_twoup=bool(config.sync_twoup), model_dtype=model_dtype,
        knn_kernel=not kernels or model_dtype != torch.float32)


class ScorePosNet(nn.Module):
    """The denoiser network (reference: models/molopt_score_model.py:272-368).
    With `time_emb_dim` > 0 the ligand atoms' input features carry the time
    step: 'simple' appends t / T (one feature, whatever the dim), 'sin' the
    sinusoidal embedding through Linear(4 dim), the tanh-approximated GELU
    (jax.nn.gelu's default) and Linear(dim) (`time_emb.1`, `time_emb.3`),
    as the JAX package computes them. model_dtype torch.bfloat16 is the JAX
    package's bf16 model (ScorePosNet(dtype=jnp.bfloat16)): embeddings,
    refine net and type head in bf16, the time embedding, the position
    update and the outputs float32."""

    def __init__(self, config: Config, protein_atom_feature_dim: int,
                 ligand_atom_feature_dim: int, max_ligand: int = 0, model_dtype=torch.float32):
        super().__init__()
        ok, reason = eager_supported(config)
        if not ok:
            raise NotImplementedError(f"the PyTorch port builds the uni_o2 configurations and "
                                      f"the EGNN denoiser of the JAX package ({reason})")
        self.config = config
        self.model_dtype = check_dtype(model_dtype)
        self.node_indicator = bool(config.node_indicator)
        self.num_classes = ligand_atom_feature_dim
        self.num_timesteps = int(config.num_diffusion_timesteps)
        self.time_emb_dim = int(config.get("time_emb_dim", 0))
        self.time_emb_mode = config.get("time_emb_mode", "simple")
        hidden = config.hidden_dim
        emb_dim = hidden - 1 if self.node_indicator else hidden
        ligand_in = ligand_atom_feature_dim
        if self.time_emb_dim > 0 and self.time_emb_mode == "sin":
            d = self.time_emb_dim
            self.time_emb = nn.Sequential(SinusoidalPosEmb(d), nn.Linear(d, 4 * d),
                                          nn.GELU(approximate="tanh"), nn.Linear(4 * d, d))
            ligand_in += d
        elif self.time_emb_dim > 0:
            ligand_in += 1
        self.protein_atom_emb = nn.Linear(protein_atom_feature_dim, emb_dim)
        self.ligand_atom_emb = nn.Linear(ligand_in, emb_dim)
        self.refine_net = build_refine_net(config, max_ligand, self.model_dtype)
        self.v_inference = nn.Sequential(
            nn.Linear(hidden, hidden), ShiftedSoftplus(),
            nn.Linear(hidden, ligand_atom_feature_dim),
        )

    def ligand_features(self, ligand_v, time_step=None):
        """The ligand atoms' input features [B, NL, C (+ time)]: the one-hot
        type, and the time step's features where the config embeds it."""
        feat = F.one_hot(ligand_v.long(), self.num_classes).float()
        if self.time_emb_dim == 0:
            return feat
        if time_step is None:
            raise ValueError(f"this config embeds the time step (time_emb_dim="
                             f"{self.time_emb_dim}, {self.time_emb_mode!r}): pass time_step")
        t = torch.as_tensor(time_step, device=feat.device).float()
        if self.time_emb_mode == "simple":
            t_feat = (t / self.num_timesteps)[:, None, None].expand(feat.shape[:2] + (1,))
        else:
            t_feat = self.time_emb(t)[:, None, :].expand(feat.shape[:2] + (self.time_emb_dim,))
        return torch.cat([feat, t_feat], dim=-1)

    def embed(self, protein_pos, protein_feat, protein_mask, ligand_pos, ligand_v, ligand_mask,
              time_step=None):
        """Atom embeddings + node indicator, composed into one context, in
        the model dtype. Returns (h, x, node_mask, mask_ligand). Under the
        hybrid cutoff the ligand slots must number the refine net's
        max_ligand."""
        rn = self.refine_net
        if rn.cutoff_mode == "hybrid" and ligand_pos.shape[1] != rn.max_ligand:
            raise ValueError(f"the hybrid graph is built for max_ligand={rn.max_ligand} ligand "
                             f"slots, got {ligand_pos.shape[1]}")
        md = self.model_dtype
        h_protein = precision.model_linear(protein_feat, self.protein_atom_emb, md)
        h_ligand = precision.model_linear(self.ligand_features(ligand_v, time_step),
                                          self.ligand_atom_emb, md)
        if self.node_indicator:
            h_protein = torch.cat([h_protein, h_protein.new_zeros(h_protein.shape[:2] + (1,))], -1)
            h_ligand = torch.cat([h_ligand, h_ligand.new_ones(h_ligand.shape[:2] + (1,))], -1)
        return G.compose_context(h_protein, h_ligand, protein_pos, ligand_pos,
                                 protein_mask, ligand_mask)

    def head(self, h, x, ligand_mask, n_protein: int) -> Dict[str, torch.Tensor]:
        """Ligand outputs, float32; padded ligand rows of final_ligand_h are
        zero."""
        final_ligand_h = h[:, n_protein:] * ligand_mask[..., None].to(h.dtype)
        logits = precision.model_sequential(self.v_inference, final_ligand_h, self.model_dtype)
        if self.model_dtype != torch.float32:
            logits, final_ligand_h, h = logits.float(), final_ligand_h.float(), h.float()
        return {
            "pred_ligand_pos": x[:, n_protein:],
            "pred_ligand_v": logits,
            "final_ligand_h": final_ligand_h,
            "final_h": h,
        }

    def forward(self, protein_pos, protein_feat, protein_mask, ligand_pos, ligand_v,
                ligand_mask, fix_x: bool = False, time_step=None) -> Dict[str, torch.Tensor]:
        """fix_x=True freezes the coordinates (the embedding export);
        time_step [B] feeds the time embedding, where the config has one."""
        h, x, node_mask, mask_ligand = self.embed(
            protein_pos, protein_feat, protein_mask, ligand_pos, ligand_v, ligand_mask, time_step)
        h, x = self.refine_net(h, x, mask_ligand, node_mask, fix_x=fix_x)
        return self.head(h, x, ligand_mask, protein_pos.shape[1])


class SampleResult(NamedTuple):
    pos: torch.Tensor  # [B, NL, 3] final ligand coordinates (uncentered)
    v: torch.Tensor  # [B, NL] final atom-type indices
    pos_traj: Optional[torch.Tensor] = None  # [S, B, NL, 3] each step's positions (uncentered)
    v_traj: Optional[torch.Tensor] = None  # [S, B, NL] each step's types
    v0_traj: Optional[torch.Tensor] = None  # [S, B, NL, C] each step's recon log-probs
    vt_traj: Optional[torch.Tensor] = None  # [S, B, NL, C] log-probs the types were drawn from


class DiffusionModel:
    """Owns the network and the schedules on one device: the CUDA card
    unless the caller asks for another (CPU callers pass device='cpu').
    `impl` is the denoiser's path that the entry points take when not told
    otherwise, read from the config and the model dtype once
    (`resolve_impl`): 'fast' (the kernels) for the released uni_o2
    architecture, else 'eager'. model_dtype is the JAX DiffusionModel's
    dtype: torch.bfloat16 builds the bf16 model, which runs eagerly
    (parameters float32); it is not the sampler's `dtype`, the kernels'
    product precision."""

    def __init__(self, config: Config, protein_atom_feature_dim: int,
                 ligand_atom_feature_dim: int, device="cuda",
                 max_protein: int = 384, max_ligand: int = 64, model_dtype=torch.float32):
        self.config = config
        self.device = torch.device(device)
        self.model_mean_type = config.model_mean_type
        self.loss_v_weight = config.get("loss_v_weight", 100.0)
        self.center_pos_mode = config.get("center_pos_mode", "protein")
        self.num_classes = ligand_atom_feature_dim
        self.max_protein, self.max_ligand = max_protein, max_ligand
        self.pos_sched = make_gaussian_schedule(
            beta_schedule=config.beta_schedule,
            num_diffusion_timesteps=config.num_diffusion_timesteps,
            beta_start=config.get("beta_start"), beta_end=config.get("beta_end"),
            pos_beta_s=config.get("pos_beta_s"), device=self.device,
        )
        self.v_sched = make_categorical_schedule(
            v_beta_schedule=config.v_beta_schedule,
            num_diffusion_timesteps=config.num_diffusion_timesteps,
            v_beta_s=config.get("v_beta_s", 0.01), device=self.device,
        )
        self.num_timesteps = self.pos_sched.num_timesteps
        self.net = ScorePosNet(config, protein_atom_feature_dim, ligand_atom_feature_dim,
                               max_ligand=max_ligand, model_dtype=model_dtype)
        self.net.to(self.device).eval()
        self.model_dtype = self.net.model_dtype
        self.impl = resolve_impl(config, self.model_dtype)

    def parameters(self):
        return self.net.parameters()

    def train(self, mode: bool = True) -> "DiffusionModel":
        self.net.train(mode)
        return self

    def eval(self) -> "DiffusionModel":
        return self.train(False)

    def apply(self, batch: ComplexBatch, ligand_pos, ligand_v, fix_x: bool = False,
              time_step=None):
        """Eager forward (the reference-semantics path); fix_x=True freezes
        the coordinates; time_step [B] feeds a config's time embedding."""
        return self.net(batch.protein_pos, batch.protein_feat, batch.protein_mask,
                        ligand_pos, ligand_v, batch.ligand_mask, fix_x=fix_x,
                        time_step=time_step)

    def fast_apply(self, batch: ComplexBatch, ligand_pos, ligand_v,
                   packed: Optional[PackedBlock] = None, mode: str = "mega",
                   fix_x: bool = False, dtype=torch.bfloat16, need_full_h: bool = True,
                   cone_workspace: Optional[ConeWorkspace] = None):
        """Kernel-backed forward (the sampling path); mode 'mega' runs the
        whole-block kernels, 'layers' the per-layer ones, fix_x=True freezes
        the coordinates, dtype the products' precision, bf16 by default as
        the JAX package's fast_apply; need_full_h=False computes the last
        block on the ligand outputs' dependency cone (in `cone_workspace`
        when given), `final_h`'s protein rows then stale (see fast_forward)."""
        return fast_forward(self.net, batch.protein_pos, batch.protein_feat,
                            batch.protein_mask, ligand_pos, ligand_v, batch.ligand_mask,
                            packed=packed, mode=mode, fix_x=fix_x, dtype=dtype,
                            need_full_h=need_full_h, cone_workspace=cone_workspace)

    def get_diffusion_loss(self, batch: ComplexBatch, time_step=None, pos_noise=None,
                           v_uniform=None, generator: Optional[torch.Generator] = None,
                           impl: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """Training loss (reference: molopt_score_model.py:485-563).
        time_step [B] int, pos_noise [B,NL,3] standard normal and v_uniform
        [B,NL,C] U[0,1) may be given; each one that is not is drawn from
        `generator`. impl='fast' runs the denoiser through the
        differentiable kernels with the whole-block backward
        (fast_train_forward), impl='fast_pl' through the per-layer kernels and
        their backwards, impl='eager' through ScorePosNet.forward; None
        takes `self.impl`. 'fast_bf16' and 'fast_bf16_pl' (the JAX names)
        are the bf16 training variant of 'fast' and 'fast_pl': the attention
        layers' products bf16 in both directions, float32 accumulation,
        parameters and gradients float32 (fast_train_forward(dtype=
        torch.bfloat16)); the other three are float32."""
        impl = impl or self.impl
        if impl not in TRAIN_IMPLS:
            raise ValueError(f"impl must be one of {', '.join(map(repr, TRAIN_IMPLS))}, "
                             f"got {impl!r}")
        B, dev = batch.num_graphs, batch.device
        lmask = batch.ligand_mask
        protein_pos, ligand_pos, _ = D.center_pos_protein(
            batch.protein_pos, batch.ligand_pos, batch.protein_mask, self.center_pos_mode)
        cbatch = batch._replace(protein_pos=protein_pos)
        if time_step is None:
            time_step, _ = D.sample_time_symmetric(B, self.num_timesteps, generator, dev)
        if pos_noise is None:
            pos_noise = torch.randn(ligand_pos.shape, generator=generator, device=dev)
        if v_uniform is None:
            v_uniform = torch.rand(batch.ligand_v.shape + (self.num_classes,),
                                   generator=generator, device=dev)

        ligand_pos_perturbed = D.perturb_pos(self.pos_sched, ligand_pos, time_step, pos_noise)
        log_ligand_v0 = D.index_to_log_onehot(batch.ligand_v, self.num_classes)
        ligand_v_perturbed, log_ligand_vt = D.q_v_sample(
            self.v_sched, log_ligand_v0, time_step, self.num_classes, v_uniform)
        if impl == "eager":
            preds = self.net(cbatch.protein_pos, cbatch.protein_feat, cbatch.protein_mask,
                             ligand_pos_perturbed, ligand_v_perturbed, lmask,
                             time_step=time_step)
        else:
            preds = fast_train_forward(self.net, cbatch.protein_pos, cbatch.protein_feat,
                                       cbatch.protein_mask, ligand_pos_perturbed,
                                       ligand_v_perturbed, lmask,
                                       whole_block_bwd=not impl.endswith("_pl"),
                                       dtype=torch.bfloat16 if "bf16" in impl
                                       else torch.float32)
        pred_ligand_pos, pred_ligand_v = preds["pred_ligand_pos"], preds["pred_ligand_v"]
        pred_pos_noise = pred_ligand_pos - ligand_pos_perturbed

        if self.model_mean_type == "C0":
            target, pred = ligand_pos, pred_ligand_pos
        elif self.model_mean_type == "noise":
            target, pred = pos_noise, pred_pos_noise
        else:
            raise ValueError(self.model_mean_type)
        loss_pos_graph = D.masked_mean(((pred - target) ** 2).sum(-1), lmask)
        loss_pos = loss_pos_graph.mean()

        log_ligand_v_recon = F.log_softmax(pred_ligand_v, dim=-1)
        log_v_model_prob = D.q_v_posterior(self.v_sched, log_ligand_v_recon, log_ligand_vt,
                                           time_step, self.num_classes)
        log_v_true_prob = D.q_v_posterior(self.v_sched, log_ligand_v0, log_ligand_vt, time_step,
                                          self.num_classes)
        kl_v = D.compute_v_Lt(log_v_model_prob, log_ligand_v0, log_v_true_prob, time_step, lmask)
        loss_v = kl_v.mean()
        return {
            "loss_pos": loss_pos,
            "loss_v": loss_v,
            "loss": loss_pos + loss_v * self.loss_v_weight,
            "loss_pos_graph": loss_pos_graph,
            "loss_v_graph": kl_v,
            "pred_ligand_pos": pred_ligand_pos,
            "pred_ligand_v": pred_ligand_v,
            "time_step": time_step,
        }

    @torch.no_grad()
    def likelihood_estimation(self, batch: ComplexBatch, time_step, pos_noise=None,
                              v_uniform=None, generator: Optional[torch.Generator] = None,
                              impl: Optional[str] = None):
        """Per-timestep ELBO terms of each complex (reference:
        molopt_score_model.py:566-617). time_step [B] int; where every entry
        is num_timesteps the prior terms come back and the network does not
        run, else the step terms at min(t, T-1). pos_noise [B,NL,3] standard
        normal and v_uniform [B,NL,C] U[0,1) may be given; each one that is
        not is drawn from `generator`. Centres on the protein whatever the
        config's mode. impl='fast' runs the denoiser on the kernels (float32),
        'eager' through ScorePosNet.forward, None `self.impl`. Returns
        (kl_pos [B], kl_v [B])."""
        impl = impl or self.impl
        if impl not in ("fast", "eager"):
            raise ValueError(f"impl must be 'fast' or 'eager', got {impl!r}")
        if self.model_mean_type != "C0":
            raise ValueError(self.model_mean_type)
        T, dev = self.num_timesteps, batch.device
        lmask = batch.ligand_mask
        protein_pos, ligand_pos, _ = D.center_pos_protein(
            batch.protein_pos, batch.ligand_pos, batch.protein_mask, "protein")
        cbatch = batch._replace(protein_pos=protein_pos)
        log_ligand_v0 = D.index_to_log_onehot(batch.ligand_v, self.num_classes)
        time_step = torch.as_tensor(time_step, device=dev).long()
        if bool((time_step == T).all()):
            return (D.kl_pos_prior(self.pos_sched, ligand_pos, lmask),
                    D.kl_v_prior(self.v_sched, log_ligand_v0, lmask, self.num_classes))

        t = time_step.clamp(max=T - 1)
        if pos_noise is None:
            pos_noise = torch.randn(ligand_pos.shape, generator=generator, device=dev)
        if v_uniform is None:
            v_uniform = torch.rand(batch.ligand_v.shape + (self.num_classes,),
                                   generator=generator, device=dev)
        ligand_pos_perturbed = D.perturb_pos(self.pos_sched, ligand_pos, t, pos_noise)
        ligand_v_perturbed, log_ligand_vt = D.q_v_sample(
            self.v_sched, log_ligand_v0, t, self.num_classes, v_uniform)
        if impl == "fast":
            preds = self.fast_apply(cbatch, ligand_pos_perturbed, ligand_v_perturbed,
                                    dtype=torch.float32, need_full_h=False)
        else:
            preds = self.apply(cbatch, ligand_pos_perturbed, ligand_v_perturbed, time_step=t)
        pos_model_mean = D.q_pos_posterior(self.pos_sched, preds["pred_ligand_pos"],
                                           ligand_pos_perturbed, t)
        log_v_recon = F.log_softmax(preds["pred_ligand_v"], dim=-1)
        log_v_model_prob = D.q_v_posterior(self.v_sched, log_v_recon, log_ligand_vt, t,
                                           self.num_classes)
        log_v_true_prob = D.q_v_posterior(self.v_sched, log_ligand_v0, log_ligand_vt, t,
                                          self.num_classes)
        kl_pos = D.compute_pos_Lt(self.pos_sched, pos_model_mean, ligand_pos,
                                  ligand_pos_perturbed, t, lmask)
        kl_v = D.compute_v_Lt(log_v_model_prob, log_ligand_v0, log_v_true_prob, t, lmask)
        return kl_pos, kl_v

    @torch.no_grad()
    def fetch_embedding(self, batch: ComplexBatch, impl: Optional[str] = None):
        """Hidden states with frozen coordinates, float32 (reference:
        molopt_score_model.py:619-631): pred_ligand_pos (the input ligand
        positions), pred_ligand_v, final_ligand_h and final_h. impl='fast'
        runs the kernels without their h2x pass, 'eager'
        ScorePosNet.forward, None `self.impl`. It passes no time step, as
        the JAX package's: a config with a time embedding raises ValueError."""
        impl = impl or self.impl
        if self.net.time_emb_dim > 0:
            raise ValueError(f"fetch_embedding passes no time step, and this config embeds one "
                             f"(time_emb_dim={self.net.time_emb_dim}, "
                             f"{self.net.time_emb_mode!r})")
        if impl == "fast":
            return self.fast_apply(batch, batch.ligand_pos, batch.ligand_v, fix_x=True,
                                   dtype=torch.float32)
        if impl != "eager":
            raise ValueError(f"impl must be 'fast' or 'eager', got {impl!r}")
        return self.apply(batch, batch.ligand_pos, batch.ligand_v, fix_x=True)

    def _x0_and_logits(self, cbatch: ComplexBatch, pos, v, tt, packed, impl: str,
                       dtype=torch.bfloat16, cone_workspace=None):
        """The model's x0 prediction and type logits at (pos, v, tt): on the
        kernels of `dtype` (impl='fast', the cone in `cone_workspace` when
        given) or through ScorePosNet.forward ('eager', float32 whatever
        dtype says)."""
        if impl == "fast":
            preds = self.fast_apply(cbatch, pos, v, packed=packed, dtype=dtype,
                                    need_full_h=False, cone_workspace=cone_workspace)
        elif impl == "eager":
            preds = self.apply(cbatch, pos, v, time_step=tt)
        else:
            raise ValueError(f"impl must be 'fast' or 'eager', got {impl!r}")
        if self.model_mean_type == "noise":
            pos0 = D.predict_x0_from_eps(self.pos_sched, pos, preds["pred_ligand_pos"] - pos, tt)
        elif self.model_mean_type == "C0":
            pos0 = preds["pred_ligand_pos"]
        else:
            raise ValueError(self.model_mean_type)
        return pos0, preds["pred_ligand_v"]

    @torch.no_grad()
    def sample_step(self, cbatch: ComplexBatch, ligand_pos, ligand_v, t: int, pos_noise,
                    type_uniform, packed: Optional[PackedBlock] = None, s: Optional[int] = None,
                    sampler: str = "ddpm", coefs=None, pos_only: bool = False,
                    return_v_probs: bool = False, impl: Optional[str] = None,
                    dtype=torch.bfloat16, cone_workspace: Optional[ConeWorkspace] = None):
        """One reverse step from timestep t to s on the protein-centered batch
        (targetdiff_tpu/models/score_model.py:_sample_step; reference:
        molopt_score_model.py:649-693). sampler='ddpm' is the ancestral step,
        s = t-1; 'ddim' jumps to any s < t, positions by the coefficients
        `coefs` = (c_x0, c_xt, sigma) of D.ddim_pos_coefficients, types by
        the strided posterior; 'dpm2' adds the Heun correction of the ddim
        jump (a second model evaluation at s). s < 0 is the final jump to the
        clean sample: its types come from the recon distribution, and dpm2
        skips the second evaluation there, whose correction the JAX step
        multiplies by 0. `pos_noise` [B,NL,3] is standard normal and
        `type_uniform` [B,NL,C] U[0,1) (None under pos_only, which holds the
        types). Returns (ligand_pos, ligand_v) at s, and with return_v_probs
        also the recon log-probabilities and those the types were drawn from.
        impl 'fast' or 'eager' and dtype (bf16 by default; `packed` must be
        packed for it) as in sample_diffusion; `cone_workspace` holds the
        dependency cones of impl='fast' (allocated each call when None)."""
        impl = impl or self.impl
        check_dtype(dtype)
        if sampler not in ("ddpm", "ddim", "dpm2"):
            raise ValueError(f"unknown sampler {sampler!r} (want 'ddpm', 'ddim' or 'dpm2')")
        s = t - 1 if s is None else s
        dev, C = ligand_pos.device, self.num_classes
        tt = torch.full((cbatch.num_graphs,), t, dtype=torch.long, device=dev)
        lmask_f = cbatch.ligand_mask.to(ligand_pos.dtype)[..., None]
        pos0, logits = self._x0_and_logits(cbatch, ligand_pos, ligand_v, tt, packed, impl, dtype,
                                           cone_workspace)

        if sampler == "ddpm":
            pos_mean = D.q_pos_posterior(self.pos_sched, pos0, ligand_pos, tt)
            pos_log_variance = D.extract(self.pos_sched.posterior_logvar, tt, 3)
            nonzero = float(t != 0)
            pos_next = pos_mean + nonzero * torch.exp(0.5 * pos_log_variance) * pos_noise
        else:
            cx0, cxt, sig = coefs
            if sampler == "dpm2" and s >= 0:
                # Heun / DPM-Solver-2 in data-prediction form: the
                # deterministic ddim proposal at s, the model evaluated there
                # on the greedy strided-posterior types, and the jump redone
                # from the average of the two x0 predictions (positions) and
                # of the two type distributions (probabilities)
                ss = torch.full_like(tt, s)
                x_prop = (cx0 * pos0 + cxt * ligand_pos) * lmask_f
                log_post_mid = D.q_v_posterior_strided(
                    self.v_sched, F.log_softmax(logits, dim=-1),
                    D.index_to_log_onehot(ligand_v, C), tt, ss, C)
                pos0_2, logits_2 = self._x0_and_logits(
                    cbatch, x_prop, torch.argmax(log_post_mid, dim=-1), ss, packed, impl, dtype,
                    cone_workspace)
                pos0 = pos0 + 0.5 * (pos0_2 - pos0)
                p_avg = 0.5 * (F.softmax(logits, dim=-1) + F.softmax(logits_2, dim=-1))
                log_avg = torch.log(p_avg.clamp(min=D.LOG_EPS))
                logits = logits + (log_avg - logits)
            pos_next = cx0 * pos0 + cxt * ligand_pos + sig * pos_noise
        pos_next = pos_next * lmask_f

        log_v_recon = F.log_softmax(logits, dim=-1)
        if pos_only:
            log_model_prob, v_next = log_v_recon, ligand_v
        else:
            log_v = D.index_to_log_onehot(ligand_v, C)
            if sampler == "ddpm":
                log_model_prob = D.q_v_posterior(self.v_sched, log_v_recon, log_v, tt, C)
            elif s < 0:
                log_model_prob = log_v_recon
            else:
                log_model_prob = D.q_v_posterior_strided(self.v_sched, log_v_recon, log_v, tt,
                                                         torch.full_like(tt, s), C)
            v_next = D.log_sample_categorical(log_model_prob, type_uniform)
        if return_v_probs:
            return pos_next, v_next, log_v_recon, log_model_prob
        return pos_next, v_next

    @torch.no_grad()
    def sample_diffusion(self, batch: ComplexBatch, init_ligand_pos, init_ligand_v,
                         generator: torch.Generator, num_steps: Optional[int] = None,
                         center_pos_mode: Optional[str] = None, pos_only: bool = False,
                         return_traj: bool = False, return_v_probs: bool = False,
                         sampler: str = "ddpm", eta: float = 0.0,
                         ddim_spacing: str = "uniform",
                         impl: Optional[str] = None,
                         noise_rows: Optional[Tuple[int, int, int]] = None,
                         dtype=torch.bfloat16) -> SampleResult:
        """The reverse process (targetdiff_tpu/models/score_model.py:
        sample_diffusion; reference: molopt_score_model.py:633-703).
        sampler='ddpm' runs the last `num_steps` timesteps of the schedule
        (the reference's truncation at :649); 'ddim' and 'dpm2' stride the
        whole schedule over `num_steps` jumps (`sampling_schedule`), with
        position noise scaled by `eta`. impl='fast' runs each step on the
        kernels, with the block weights packed and a `ConeWorkspace` for the
        dependency cones made once per run; 'eager' through
        ScorePosNet.forward (the EGNN denoiser's path), None `self.impl`.
        dtype: the kernels' products, torch.bfloat16 (the default, as the
        JAX package's sample_diffusion) or torch.float32; 'eager' ignores
        it. The jump coefficients
        are uploaded once per run; each step draws its noise from
        `generator`. return_traj keeps every step's positions
        (uncentered, padded rows at the offset) and types on the device,
        return_v_probs every step's recon and sampling log-probabilities.
        noise_rows = (n, start, stop) says that `batch` is the rows
        [start, stop) of n: each step's noise is drawn for all n rows and
        sliced, as a one-process run draws it (sharded sampling; a rank
        with no rows only draws)."""
        T = self.num_timesteps
        num_steps = T if num_steps is None else num_steps
        time_seq, s_seq = sampling_schedule(T, num_steps, sampler, ddim_spacing)
        protein_pos, pos, offset = D.center_pos_protein(
            batch.protein_pos, init_ligand_pos, batch.protein_mask,
            center_pos_mode or self.center_pos_mode)
        cbatch = batch._replace(protein_pos=protein_pos)
        dev = pos.device
        impl = impl or self.impl
        if impl not in ("fast", "eager"):
            raise ValueError(f"impl must be 'fast' or 'eager', got {impl!r}")
        check_dtype(dtype)
        packed = cone_workspace = None
        if impl == "fast":
            require_kernels(self.config)
            packed = pack_block_params(self.net.refine_net, dtype)
            cone_workspace = ConeWorkspace()
        coefs = None
        if sampler != "ddpm":
            betas = self.pos_sched.betas.cpu().numpy()
            coefs = torch.as_tensor(np.stack(D.ddim_pos_coefficients(betas, time_seq, s_seq, eta),
                                             1), device=dev)
        S = len(time_seq)
        v = init_ligand_v
        traj = {}
        if return_traj:
            traj["pos_traj"] = pos.new_empty((S,) + pos.shape)
            traj["v_traj"] = v.new_empty((S,) + v.shape)
        if return_v_probs:
            traj["v0_traj"] = pos.new_empty((S,) + v.shape + (self.num_classes,))
            traj["vt_traj"] = torch.empty_like(traj["v0_traj"])
        n, start, stop = noise_rows or (pos.shape[0], 0, pos.shape[0])
        if stop - start != pos.shape[0]:
            raise ValueError(f"noise_rows {noise_rows} do not match a batch of {pos.shape[0]}")
        for i, (t, s) in enumerate(zip(time_seq.tolist(), s_seq.tolist())):
            pos_noise = torch.randn((n,) + pos.shape[1:], generator=generator,
                                    device=dev)[start:stop]
            type_uniform = None if pos_only else torch.rand(
                (n,) + v.shape[1:] + (self.num_classes,), generator=generator,
                device=dev)[start:stop]
            if stop == start:
                continue
            out = self.sample_step(cbatch, pos, v, t, pos_noise, type_uniform, packed=packed,
                                   s=s, sampler=sampler,
                                   coefs=None if coefs is None else coefs[i], pos_only=pos_only,
                                   return_v_probs=return_v_probs, impl=impl, dtype=dtype,
                                   cone_workspace=cone_workspace)
            pos, v = out[:2]
            if return_traj:
                traj["pos_traj"][i] = pos + offset
                traj["v_traj"][i] = v
            if return_v_probs:
                traj["v0_traj"][i], traj["vt_traj"][i] = out[2:]
        return SampleResult(pos=pos + offset, v=v, **traj)


def sampling_schedule(num_timesteps: int, num_steps: int, sampler: str = "ddpm",
                      ddim_spacing: str = "uniform"):
    """The (t, s) jumps of a reverse run, as int64 numpy arrays (time_seq,
    s_seq) (targetdiff_tpu/models/score_model.py:635-657). ddpm: the last
    `num_steps` timesteps, s = t-1. ddim and dpm2: `num_steps` grid points
    over the whole schedule, 'uniform' or 'quadratic' (denser at low t, where
    the fine geometry is decided), rounded, deduplicated and descending, each
    jumping to the next; the last jumps to s = -1, the clean sample."""
    if sampler in ("ddim", "dpm2"):
        if ddim_spacing == "quadratic":
            grid = np.linspace(0.0, 1.0, num_steps) ** 2 * (num_timesteps - 1)
        elif ddim_spacing == "uniform":
            grid = np.linspace(0, num_timesteps - 1, num_steps)
        else:
            raise ValueError(f"unknown ddim_spacing {ddim_spacing!r}")
        time_seq = np.unique(grid.round().astype(np.int64))[::-1].copy()
        return time_seq, np.append(time_seq[1:], -1)
    if sampler == "ddpm":
        time_seq = np.arange(num_timesteps - num_steps, num_timesteps)[::-1].copy()
        return time_seq, time_seq - 1
    raise ValueError(f"unknown sampler {sampler!r} (want 'ddpm', 'ddim' or 'dpm2')")
