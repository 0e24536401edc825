"""Training steps, counterpart of targetdiff_tpu/trainer.py (reference:
scripts/train_diffusion.py:116-208): protein-position noise augmentation
(std `train.pos_noise_std`), Adam behind global-norm clipping, symmetric or
importance time sampling with an EMA of the per-timestep loss, and
validation at fixed timesteps with the atom-type AUROC.

PyTorch runs eagerly, so a step updates the TrainState's model and optimizer
in place; its random draws come from a `torch.Generator` or are given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .data.batch import ComplexBatch
from .models.score_model import DiffusionModel
from .ops import diffusion as D
from .utils.train import ClippedOptimizer


@dataclass
class TrainState:
    """The model and optimizer being trained, the step count, and the
    per-timestep loss statistics for importance sampling. The reference
    allocates these buffers but never updates them (molopt_score_model.py:
    269-270, :440-451); here they are an EMA, as in the JAX package."""

    model: DiffusionModel
    optimizer: ClippedOptimizer
    step: int
    Lt_history: torch.Tensor  # [T] float32
    Lt_count: torch.Tensor  # [T] float32


def create_train_state(model: DiffusionModel, optimizer: ClippedOptimizer) -> TrainState:
    T = model.num_timesteps
    return TrainState(model=model, optimizer=optimizer, step=0,
                      Lt_history=torch.zeros(T, device=model.device),
                      Lt_count=torch.zeros(T, device=model.device))


def update_Lt_ema(state: TrainState, t: torch.Tensor, vlb_graph: torch.Tensor) -> None:
    """EMA of the per-timestep loss. Duplicate timesteps within a batch are
    first reduced to their mean, so every duplicate counts and the result
    does not depend on the order (trainer.py:132-147 of the JAX package)."""
    T = state.Lt_history.shape[0]
    vlb = vlb_graph.detach().to(state.Lt_history.dtype)
    sums = torch.zeros(T, device=vlb.device).index_add_(0, t, vlb)
    counts = torch.zeros(T, device=vlb.device).index_add_(0, t, torch.ones_like(vlb))
    mean = sums / counts.clamp(min=1.0)
    ema = torch.where(state.Lt_count > 0, 0.9 * state.Lt_history + 0.1 * mean, mean)
    state.Lt_history = torch.where(counts > 0, ema, state.Lt_history)
    state.Lt_count = state.Lt_count + counts


def make_train_step(model: DiffusionModel, pos_noise_std: float = 0.0,
                    time_sampling: str = "symmetric", impl: Optional[str] = None):
    """Returns train_step(state, batch, generator, time_step=None,
    pos_noise=None, v_uniform=None) -> (state, metrics). Draws not given
    come from `generator`; metrics (loss, loss_pos, loss_v, grad_norm, the
    norm before clipping) are 0-d tensors on the device. The denoiser runs
    as `get_diffusion_loss(impl=impl)`: 'fast' on the kernels with the
    whole-block backward, 'fast_pl' on the per-layer kernels, 'eager' on
    the plain network (targetdiff_tpu/trainer.py:81), None the model's
    `impl`, read from its config."""
    if time_sampling not in ("symmetric", "importance"):
        raise ValueError(f"time_sampling must be 'symmetric' or 'importance', "
                         f"got {time_sampling!r}")

    def train_step(state: TrainState, batch: ComplexBatch, generator: torch.Generator,
                   time_step=None, pos_noise=None, v_uniform=None):
        model.train()
        if pos_noise_std > 0:
            noise = torch.randn(batch.protein_pos.shape, generator=generator,
                                device=batch.device) * pos_noise_std
            noise = noise * batch.protein_mask[..., None].to(noise.dtype)
            batch = batch._replace(protein_pos=batch.protein_pos + noise)
        if time_step is None and time_sampling == "importance":
            time_step, _ = D.sample_time_importance(batch.num_graphs, state.Lt_history,
                                                    state.Lt_count, generator)
        state.optimizer.zero_grad()
        out = model.get_diffusion_loss(batch, time_step=time_step, pos_noise=pos_noise,
                                       v_uniform=v_uniform, generator=generator, impl=impl)
        out["loss"].backward()
        grad_norm = state.optimizer.step()
        update_Lt_ema(state, out["time_step"],
                      out["loss_pos_graph"] + model.loss_v_weight * out["loss_v_graph"])
        state.step += 1
        metrics = {k: out[k].detach() for k in ("loss", "loss_pos", "loss_v")}
        metrics["grad_norm"] = grad_norm.detach()
        return state, metrics

    return train_step


def make_eval_step(model: DiffusionModel, impl: Optional[str] = None):
    """eval_step(batch, t_scalar, generator) -> loss, loss_pos, loss_v and
    pred_v at one fixed timestep (reference: scripts/train_diffusion.py:
    160-189 loops t over linspace(0, T-1, 10)), the denoiser run as
    `get_diffusion_loss(impl=impl)`."""

    @torch.no_grad()
    def eval_step(batch: ComplexBatch, t_scalar: int, generator: Optional[torch.Generator]):
        model.eval()
        t = torch.full((batch.num_graphs,), int(t_scalar), dtype=torch.long, device=batch.device)
        out = model.get_diffusion_loss(batch, time_step=t, generator=generator, impl=impl)
        return {"loss": out["loss"], "loss_pos": out["loss_pos"], "loss_v": out["loss_v"],
                "pred_v": out["pred_ligand_v"]}

    return eval_step


def _auroc(y: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve from the scores' ranks; ties count one half
    (the Mann-Whitney U statistic, as sklearn's roc_auc_score)."""
    order = np.argsort(score, kind="mergesort")
    ranks = np.empty(len(score), np.float64)
    ranks[order] = np.arange(1, len(score) + 1)
    _, inv, counts = np.unique(score, return_inverse=True, return_counts=True)
    sums = np.bincount(inv, weights=ranks)
    ranks = (sums / counts)[inv]  # tied scores share their mean rank
    n_pos = int(y.sum())
    n_neg = len(y) - n_pos
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def atom_auroc(y_true: np.ndarray, y_prob: np.ndarray, mask: np.ndarray) -> float:
    """Mean per-class one-vs-rest AUROC weighted by class frequency
    (reference: scripts/train_diffusion.py:22-36)."""
    y_true, y_prob = y_true[mask], y_prob[mask]
    scores, weights = [], []
    for c in range(y_prob.shape[-1]):
        y_c = y_true == c
        n = int(y_c.sum())
        if n == 0 or n == len(y_c):
            continue
        scores.append(_auroc(y_c, y_prob[:, c]))
        weights.append(n)
    return float(np.average(scores, weights=weights)) if scores else float("nan")
