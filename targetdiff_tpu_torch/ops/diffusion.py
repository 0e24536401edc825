"""DDPM math on dense padded tensors, counterpart of the sampling (ddpm and
the strided samplers), training and likelihood subsets of
targetdiff_tpu/ops/diffusion.py (reference: models/molopt_score_model.py).

`t` is an int tensor of shape [B]; coordinates are [B, N, 3]; atom-type
log-probabilities are [B, N, C]. Functions that need randomness take it as an
argument (noise tensors, or a torch.Generator) so that the caller owns the
generator.
"""

from __future__ import annotations

import math

import numpy as np
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


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between diagonal Gaussians, summed over the last axis (reference:
    :146-151)."""
    kl = 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                + (mean1 - mean2) ** 2 * torch.exp(-logvar2))
    return kl.sum(-1)


def log_normal(values, means, log_scales):
    """Gaussian log-density, summed over the last axis (reference: :154-157)."""
    var = torch.exp(log_scales * 2)
    log_prob = (-((values - means) ** 2) / (2 * var) - log_scales
                - math.log(math.sqrt(2 * math.pi)))
    return log_prob.sum(-1)


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


def q_v_pred_strided(sched: CategoricalSchedule, log_vt, t, s, num_classes: int):
    """log q(v_t | v_s) for a jump s < t under the uniform-mixture kernel,
    alpha_{t|s} = abar_t / abar_s (targetdiff_tpu/ops/diffusion.py:142; the
    reference steps only t -> t-1). s < 0 reads as s = 0."""
    log_a_ts = (extract(sched.log_alphas_cumprod, t, log_vt.ndim)
                - extract(sched.log_alphas_cumprod, torch.clamp(s, min=0), log_vt.ndim))
    # log(1 - a_ts) through -expm1: log1p(-exp(x)) collapses to log(eps) in
    # float32 once exp(x) rounds to 1
    log_1_min_a_ts = torch.log(-torch.expm1(log_a_ts) + LOG_EPS)
    return log_add_exp(log_vt + log_a_ts, log_1_min_a_ts - math.log(num_classes))


def q_v_posterior_strided(sched: CategoricalSchedule, log_v0, log_vt, t, s, num_classes: int):
    """log q(v_s | v_t, v_0) for a jump s < t, normalized over classes; with
    s = t-1 it equals q_v_posterior. On the final jump (s < 0) samplers use
    the recon distribution log_v0 itself."""
    unnormed = (q_v_pred(sched, log_v0, torch.clamp(s, min=0), num_classes)
                + q_v_pred_strided(sched, log_vt, t, s, num_classes))
    return unnormed - torch.logsumexp(unnormed, dim=-1, keepdim=True)


def ddim_pos_coefficients(betas, time_seq, s_seq, eta: float = 0.0):
    """Host-side DDIM coefficient tables for the jumps t = time_seq[i] ->
    s = s_seq[i] (Song et al. 2021), x_s = c_x0 x0 + c_xt x_t + sigma xi with
    sigma = eta sqrt((1-abar_s)/(1-abar_t)) sqrt(1 - abar_t/abar_s). Computed
    in float64 from `betas` (the schedule's float32 betas, upcast as the JAX
    package does), because 1 - abar_t/abar_s underflows float32 where beta
    ~ 1e-7; s < 0 is the final jump to the clean sample (c_x0 = 1, c_xt =
    sigma = 0). Returns float32 numpy arrays (c_x0, c_xt, sigma), bitwise
    targetdiff_tpu/ops/diffusion.py:ddim_pos_coefficients."""
    acp = np.cumprod(1.0 - np.asarray(betas, np.float64))
    t = np.asarray(time_seq, np.int64)
    s = np.asarray(s_seq, np.int64)
    abar_t = acp[t]
    abar_s = np.where(s >= 0, acp[np.maximum(s, 0)], 1.0)
    sigma = eta * np.sqrt(
        np.clip((1.0 - abar_s) / np.clip(1.0 - abar_t, 1e-300, None), 0.0, None)
        * np.clip(1.0 - abar_t / abar_s, 0.0, None))
    dir_coef = np.sqrt(np.clip(1.0 - abar_s - sigma**2, 0.0, None))
    c_xt = dir_coef / np.sqrt(np.clip(1.0 - abar_t, 1e-300, None))
    c_x0 = np.sqrt(abar_s) - c_xt * np.sqrt(abar_t)
    return tuple(np.asarray(a, np.float32) for a in (c_x0, c_xt, sigma))


def kl_v_prior(sched: CategoricalSchedule, log_v0, mask, num_classes: int):
    """Per-graph mean KL(q(v_T | v_0) || uniform) over real atoms, [B]
    (reference: :411-417)."""
    t_last = torch.full((log_v0.shape[0],), sched.num_timesteps - 1, dtype=torch.long,
                        device=log_v0.device)
    log_qvT = q_v_pred(sched, log_v0, t_last, num_classes)
    log_uniform = torch.full_like(log_qvT, -math.log(num_classes))
    return masked_mean(categorical_kl(log_qvT, log_uniform), mask)


def predict_x0_from_eps(sched: GaussianSchedule, xt, eps, t):
    """(reference: :419-422)."""
    return (extract(sched.sqrt_recip_alphas_cumprod, t, xt.ndim) * xt
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, xt.ndim) * eps)


def q_pos_posterior(sched: GaussianSchedule, x0, xt, t):
    """Mean of q(x_{t-1} | x_t, x_0) (reference: :424-428)."""
    return (extract(sched.posterior_mean_c0_coef, t, x0.ndim) * x0
            + extract(sched.posterior_mean_ct_coef, t, xt.ndim) * xt)


def kl_pos_prior(sched: GaussianSchedule, pos0, mask):
    """Per-graph mean KL(q(x_T | x_0) || N(0, I)) over real atoms, [B]
    (reference: :430-438)."""
    t_last = torch.full((pos0.shape[0],), sched.num_timesteps - 1, dtype=torch.long,
                        device=pos0.device)
    a_pos = extract(sched.alphas_cumprod, t_last, pos0.ndim)
    pos_model_mean = torch.sqrt(a_pos) * pos0
    pos_log_variance = torch.log(torch.sqrt(1.0 - a_pos))
    kl = normal_kl(torch.zeros_like(pos_model_mean), torch.zeros_like(pos_model_mean),
                   pos_model_mean, pos_log_variance.expand_as(pos_model_mean))
    return masked_mean(kl, mask)


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


# ---- training: perturbation, KL terms, time sampling (reference: :440-563) ----


def perturb_pos(sched: GaussianSchedule, pos0, t, eps):
    """x_t = sqrt(a_bar) x_0 + sqrt(1 - a_bar) eps, with eps [B,N,3]
    standard normal given (reference: :497-504)."""
    a = extract(sched.alphas_cumprod, t, pos0.ndim)
    return torch.sqrt(a) * pos0 + torch.sqrt(1.0 - a) * eps


def q_v_sample(sched: CategoricalSchedule, log_v0, t, num_classes: int, uniform):
    """v_t ~ q(v_t | v_0) by Gumbel-max on the uniforms [B,N,C]; returns
    (indices, log one-hot) (reference: :394-398)."""
    idx = log_sample_categorical(q_v_pred(sched, log_v0, t, num_classes), uniform)
    return idx, index_to_log_onehot(idx, num_classes)


def categorical_kl(log_prob1, log_prob2):
    """KL(p1 || p2) per atom over the class axis (reference: :137-139)."""
    return (torch.exp(log_prob1) * (log_prob1 - log_prob2)).sum(-1)


def log_categorical(log_x_start, log_prob):
    """E_{x0}[log p(x0)] per atom (reference: :142-143)."""
    return (torch.exp(log_x_start) * log_prob).sum(-1)


def masked_mean(x, mask, dim: int = -1):
    """Mean of x over `dim` counting only mask == True entries."""
    m = mask.to(x.dtype)
    return (x * m).sum(dim) / m.sum(dim).clamp(min=1.0)


def masked_sum(x, mask, dim: int = -1):
    """Sum of x over `dim` counting only mask == True entries."""
    return (x * mask.to(x.dtype)).sum(dim)


def compute_pos_Lt(sched: GaussianSchedule, pos_model_mean, x0, xt, t, mask):
    """Per-graph position KL in bits (t > 0) or decoder NLL (t = 0), [B]
    (reference: :464-475)."""
    pos_log_variance = extract(sched.posterior_logvar, t, x0.ndim)
    pos_true_mean = q_pos_posterior(sched, x0, xt, t)
    logvar = pos_log_variance.expand_as(pos_true_mean)
    kl_pos = normal_kl(pos_true_mean, logvar, pos_model_mean, logvar) / math.log(2.0)
    decoder_nll = -log_normal(x0, pos_model_mean, 0.5 * pos_log_variance)
    t_is_0 = (t == 0).to(x0.dtype)[:, None]
    return masked_mean(t_is_0 * decoder_nll + (1.0 - t_is_0) * kl_pos, mask)


def compute_v_Lt(log_v_model_prob, log_v0, log_v_true_prob, t, mask):
    """Per-graph atom-type KL (t > 0) or decoder NLL (t = 0), [B]
    (reference: :477-483)."""
    kl_v = categorical_kl(log_v_true_prob, log_v_model_prob)
    decoder_nll_v = -log_categorical(log_v0, log_v_model_prob)
    t_is_0 = (t == 0).to(kl_v.dtype)[:, None]
    return masked_mean(t_is_0 * decoder_nll_v + (1.0 - t_is_0) * kl_v, mask)


def sample_time_symmetric(num_graphs: int, num_timesteps: int, generator, device):
    """Antithetic timesteps t and T-1-t (reference: :453-459). Returns
    (t [B] int64, pt [B])."""
    half = num_graphs // 2 + 1
    t_half = torch.randint(0, num_timesteps, (half,), generator=generator, device=device)
    t = torch.cat([t_half, num_timesteps - t_half - 1])[:num_graphs]
    return t, torch.full((num_graphs,), 1.0 / num_timesteps, device=device)


def sample_time_importance(num_graphs: int, Lt_history, Lt_count, generator):
    """Timesteps weighted by sqrt(E[L_t^2]) once every bucket has more than
    10 samples, symmetric before that (reference: :440-451). Both draws are
    made either way, so the generator advances alike, and the choice is made
    on the device, so the host does not wait for it. Returns (t, pt)."""
    T = Lt_history.shape[0]
    ready = (Lt_count > 10).all()
    Lt_sqrt = torch.sqrt(Lt_history + 1e-10) + 0.0001
    Lt_sqrt[0] = Lt_sqrt[1]
    pt_all = Lt_sqrt / Lt_sqrt.sum()
    t_imp = torch.multinomial(pt_all, num_graphs, replacement=True, generator=generator)
    t_sym, pt_sym = sample_time_symmetric(num_graphs, T, generator, Lt_history.device)
    return torch.where(ready, t_imp, t_sym), torch.where(ready, pt_all[t_imp], pt_sym)
