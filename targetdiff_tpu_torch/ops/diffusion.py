"""DDPM math on dense padded tensors, counterpart of the sampling subset of
targetdiff_tpu/ops/diffusion.py (reference: models/molopt_score_model.py).

`t` is an int tensor of shape [B]; coordinates are [B, N, 3]; atom-type
log-probabilities are [B, N, C]. Functions that need randomness take it as an
argument so that the caller owns the generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .schedules import CategoricalSchedule, GaussianSchedule

LOG_EPS = 1e-30


def extract(coef: torch.Tensor, t: torch.Tensor, ndim: int = 3) -> torch.Tensor:
    """coef[t] reshaped to [B, 1, ..., 1] with `ndim` dims (reference: :706-708)."""
    out = coef[t]
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))


def index_to_log_onehot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Class indices -> log one-hot with log(0) clamped to log(1e-30)."""
    onehot = F.one_hot(x.long(), num_classes).float()
    return torch.log(onehot.clamp(min=LOG_EPS))


def log_sample_categorical(logits: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
    """Gumbel-max sample of class indices from (log-)probabilities, with the
    uniform noise [..., C] given explicitly (reference: :160-166)."""
    gumbel = -torch.log(-torch.log(uniform + LOG_EPS) + LOG_EPS)
    return torch.argmax(gumbel + logits, dim=-1)


def log_add_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    maximum = torch.maximum(a, b)
    return maximum + torch.log(torch.exp(a - maximum) + torch.exp(b - maximum))


def q_v_pred_one_timestep(sched: CategoricalSchedule, log_vt_1, t, num_classes: int):
    """log q(v_t | v_{t-1}) (reference: :371-381)."""
    log_alpha_t = extract(sched.log_alphas, t, log_vt_1.ndim)
    log_1_min_alpha_t = extract(sched.log_one_minus_alphas, t, log_vt_1.ndim)
    return log_add_exp(log_vt_1 + log_alpha_t, log_1_min_alpha_t - math.log(num_classes))


def q_v_pred(sched: CategoricalSchedule, log_v0, t, num_classes: int):
    """log q(v_t | v_0) (reference: :383-392)."""
    log_cum = extract(sched.log_alphas_cumprod, t, log_v0.ndim)
    log_1_min_cum = extract(sched.log_one_minus_alphas_cumprod, t, log_v0.ndim)
    return log_add_exp(log_v0 + log_cum, log_1_min_cum - math.log(num_classes))


def q_v_posterior(sched: CategoricalSchedule, log_v0, log_vt, t, num_classes: int):
    """log q(v_{t-1} | v_t, v_0), normalized over classes (reference: :401-409)."""
    t_minus_1 = torch.clamp(t - 1, min=0)  # t=0 value unused by the decoder term
    unnormed = q_v_pred(sched, log_v0, t_minus_1, num_classes) + q_v_pred_one_timestep(
        sched, log_vt, t, num_classes
    )
    return unnormed - torch.logsumexp(unnormed, dim=-1, keepdim=True)


def predict_x0_from_eps(sched: GaussianSchedule, xt, eps, t):
    """(reference: :419-422)."""
    return (extract(sched.sqrt_recip_alphas_cumprod, t, xt.ndim) * xt
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, xt.ndim) * eps)


def q_pos_posterior(sched: GaussianSchedule, x0, xt, t):
    """Mean of q(x_{t-1} | x_t, x_0) (reference: :424-428)."""
    return (extract(sched.posterior_mean_c0_coef, t, x0.ndim) * x0
            + extract(sched.posterior_mean_ct_coef, t, xt.ndim) * xt)


def center_pos_protein(protein_pos, ligand_pos, protein_mask, mode: str = "protein"):
    """Shift each complex so the protein's center of mass is at the origin
    (reference: :110-120). Returns (protein_pos, ligand_pos, offset [B,1,3])."""
    if mode == "none":
        return protein_pos, ligand_pos, protein_pos.new_zeros((protein_pos.shape[0], 1, 3))
    if mode != "protein":
        raise NotImplementedError(mode)
    m = protein_mask.to(protein_pos.dtype)[..., None]
    offset = (protein_pos * m).sum(1, keepdim=True) / m.sum(1, keepdim=True).clamp(min=1.0)
    return protein_pos - offset, ligand_pos - offset, offset
