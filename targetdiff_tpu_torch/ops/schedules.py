"""Diffusion variance schedules, counterpart of targetdiff_tpu/ops/schedules.py.

Schedules are computed once in float64 numpy and held as float32 tensors on
the model's device (reference: models/molopt_score_model.py:48-97, :221-267).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def get_beta_schedule(beta_schedule: str, *, beta_start: float, beta_end: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    """quad | linear | const | jsd | sigmoid (reference: :48-78)."""
    T = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, T, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(T, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(T, 1, T, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, T)
        betas = 1.0 / (1.0 + np.exp(-x)) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(beta_schedule)
    return betas


def cosine_alpha_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Per-step sqrt(alpha) of the cosine schedule (reference: :81-97)."""
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    acp = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    acp = acp / acp[0]
    return np.sqrt(np.clip(acp[1:] / acp[:-1], a_min=0.001, a_max=1.0))


def _log_1_min_a(a: np.ndarray) -> np.ndarray:
    return np.log(1 - np.exp(a) + 1e-40)


class GaussianSchedule(NamedTuple):
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_mean_c0_coef: torch.Tensor
    posterior_mean_ct_coef: torch.Tensor
    posterior_var: torch.Tensor
    posterior_logvar: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


class CategoricalSchedule(NamedTuple):
    log_alphas: torch.Tensor
    log_one_minus_alphas: torch.Tensor
    log_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.log_alphas.shape[0]


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float32, device=device)


def make_gaussian_schedule(*, beta_schedule: str, num_diffusion_timesteps: int,
                           beta_start: float = None, beta_end: float = None,
                           pos_beta_s: float = None, device="cpu") -> GaussianSchedule:
    if beta_schedule == "cosine":
        alphas = cosine_alpha_schedule(num_diffusion_timesteps, pos_beta_s) ** 2
        betas = 1.0 - alphas
    else:
        betas = get_beta_schedule(beta_schedule, beta_start=beta_start, beta_end=beta_end,
                                  num_diffusion_timesteps=num_diffusion_timesteps)
        alphas = 1.0 - betas
    acp = np.cumprod(alphas, axis=0)
    acp_prev = np.append(1.0, acp[:-1])
    posterior_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    t = lambda x: _tensor(x, device)  # noqa: E731
    return GaussianSchedule(
        betas=t(betas),
        alphas_cumprod=t(acp),
        alphas_cumprod_prev=t(acp_prev),
        sqrt_alphas_cumprod=t(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=t(np.sqrt(1.0 - acp)),
        sqrt_recip_alphas_cumprod=t(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=t(np.sqrt(1.0 / acp - 1)),
        posterior_mean_c0_coef=t(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_ct_coef=t((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        posterior_var=t(posterior_var),
        # variance is 0 at t=0; clip the log by reusing t=1's value
        posterior_logvar=t(np.log(np.append(posterior_var[1], posterior_var[1:]))),
    )


def make_categorical_schedule(*, v_beta_schedule: str, num_diffusion_timesteps: int,
                              v_beta_s: float = 0.01, device="cpu") -> CategoricalSchedule:
    if v_beta_schedule != "cosine":
        raise NotImplementedError(v_beta_schedule)
    log_alphas = np.log(cosine_alpha_schedule(num_diffusion_timesteps, v_beta_s))
    log_acp = np.cumsum(log_alphas)
    t = lambda x: _tensor(x, device)  # noqa: E731
    return CategoricalSchedule(
        log_alphas=t(log_alphas),
        log_one_minus_alphas=t(_log_1_min_a(log_alphas)),
        log_alphas_cumprod=t(log_acp),
        log_one_minus_alphas_cumprod=t(_log_1_min_a(log_acp)),
    )
