"""Training steps, counterpart of targetdiff_tpu/trainer.py (reference:
scripts/train_diffusion.py:116-208): protein-position noise augmentation
(std `train.pos_noise_std`), Adam behind global-norm clipping, symmetric or
importance time sampling with an EMA of the per-timestep loss, and
validation at fixed timesteps with the atom-type AUROC.

PyTorch runs eagerly, so a step updates the TrainState's model and optimizer
in place; its random draws come from a `torch.Generator` or are given.

With a `parallel.mesh.Mesh` the steps are data parallel (the JAX package's
dp-sharded step): every rank passes the same global batch and a generator
seeded alike; the draws are taken at the global shape and each rank keeps
its rows, computes the loss on them, and the gradients are averaged over
the ranks before the clipped Adam step, so the clip sees the global norm.
The Lt EMA sees the gathered global timesteps and losses, and the metrics
are global means: the step is the one-process step on the global batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .data.batch import ComplexBatch
from .models.score_model import DiffusionModel
from .ops import diffusion as D
from .parallel.mesh import (Mesh, all_reduce_grads, all_reduce_sum, gather_rows, row_range,
                            shard_rows)
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


def global_draws(model: DiffusionModel, batch: ComplexBatch, generator, time_step=None,
                 pos_noise=None, v_uniform=None):
    """get_diffusion_loss's draws for the whole batch, in its order: the
    symmetric timesteps, the position noise and the type uniforms, each
    drawn from `generator` where not given."""
    B, dev = batch.num_graphs, batch.device
    if time_step is None:
        time_step, _ = D.sample_time_symmetric(B, model.num_timesteps, generator, dev)
    if pos_noise is None:
        pos_noise = torch.randn(batch.ligand_pos.shape, generator=generator, device=dev)
    if v_uniform is None:
        v_uniform = torch.rand(batch.ligand_v.shape + (model.num_classes,), generator=generator,
                               device=dev)
    return time_step, pos_noise, v_uniform


def step_inputs(model: DiffusionModel, state: TrainState, batch: ComplexBatch, generator,
                pos_noise_std: float = 0.0, time_sampling: str = "symmetric", time_step=None,
                pos_noise=None, v_uniform=None):
    """A train step's draws for the whole batch, in its order: the protein
    position noise (std `pos_noise_std`), the importance timesteps, then
    `global_draws`. Returns (the batch with its protein noised, time_step,
    pos_noise, v_uniform)."""
    if pos_noise_std > 0:
        noise = torch.randn(batch.protein_pos.shape, generator=generator,
                            device=batch.device) * pos_noise_std
        noise = noise * batch.protein_mask[..., None].to(noise.dtype)
        batch = batch._replace(protein_pos=batch.protein_pos + noise)
    if time_step is None and time_sampling == "importance":
        time_step, _ = D.sample_time_importance(batch.num_graphs, state.Lt_history,
                                                state.Lt_count, generator)
    return (batch,) + global_draws(model, batch, generator, time_step, pos_noise, v_uniform)


def make_train_step(model: DiffusionModel, pos_noise_std: float = 0.0,
                    time_sampling: str = "symmetric", impl: Optional[str] = None,
                    mesh: Optional[Mesh] = None):
    """Returns train_step(state, batch, generator, time_step=None,
    pos_noise=None, v_uniform=None) -> (state, metrics). Draws not given
    come from `generator`; metrics (loss, loss_pos, loss_v, grad_norm, the
    norm before clipping) are 0-d tensors on the device. The denoiser runs
    as `get_diffusion_loss(impl=impl)`: 'fast' on the kernels with the
    whole-block backward, 'fast_pl' on the per-layer kernels, 'eager' on
    the plain network (targetdiff_tpu/trainer.py:81), 'fast_bf16' and
    'fast_bf16_pl' the bf16 training variant of the first two (bf16
    products both ways; parameters, gradients and the optimizer float32),
    None the model's `impl`, read from its config. With a `mesh`, `batch` and the given
    draws are global (every rank passes the same), their rows must split
    equally over the ranks, and the step is data parallel (module
    docstring)."""
    if time_sampling not in ("symmetric", "importance"):
        raise ValueError(f"time_sampling must be 'symmetric' or 'importance', "
                         f"got {time_sampling!r}")

    def train_step(state: TrainState, batch: ComplexBatch, generator: torch.Generator,
                   time_step=None, pos_noise=None, v_uniform=None):
        model.train()
        B = batch.num_graphs
        if mesh is not None and B % mesh.world:
            raise ValueError(f"a batch of {B} complexes does not split over {mesh.world} ranks")
        batch, *draws = step_inputs(model, state, batch, generator, pos_noise_std, time_sampling,
                                    time_step, pos_noise, v_uniform)
        if mesh is not None:
            start, stop = row_range(B, mesh)
            draws = [d[start:stop] for d in draws]
            batch = shard_rows(batch, mesh)
        state.optimizer.zero_grad()
        out = model.get_diffusion_loss(batch, *draws, impl=impl)
        out["loss"].backward()
        t = out["time_step"]
        vlb = (out["loss_pos_graph"] + model.loss_v_weight * out["loss_v_graph"]).detach()
        metrics = torch.stack([out[k].detach() for k in ("loss", "loss_pos", "loss_v")])
        if mesh is not None:
            all_reduce_grads(model.parameters(), mesh)
            t, vlb = gather_rows(t, B, mesh), gather_rows(vlb, B, mesh)
            metrics = all_reduce_sum(metrics, mesh) / mesh.world
        grad_norm = state.optimizer.step()
        update_Lt_ema(state, t, vlb)
        state.step += 1
        metrics = dict(zip(("loss", "loss_pos", "loss_v"), metrics.unbind()))
        metrics["grad_norm"] = grad_norm.detach()
        return state, metrics

    return train_step


def make_eval_step(model: DiffusionModel, impl: Optional[str] = None,
                   mesh: Optional[Mesh] = None):
    """eval_step(batch, t_scalar, generator) -> loss, loss_pos, loss_v and
    pred_v at one fixed timestep (reference: scripts/train_diffusion.py:
    160-189 loops t over linspace(0, T-1, 10)), the denoiser run as
    `get_diffusion_loss(impl=impl)`. With a `mesh`, `batch` is global and
    may split unequally (a last batch): each rank computes its rows, the
    losses come back as the global means and pred_v for every row, on
    every rank."""

    @torch.no_grad()
    def eval_step(batch: ComplexBatch, t_scalar: int, generator: Optional[torch.Generator]):
        model.eval()
        B = batch.num_graphs
        t = torch.full((B,), int(t_scalar), dtype=torch.long, device=batch.device)
        if mesh is None:
            out = model.get_diffusion_loss(batch, time_step=t, generator=generator, impl=impl)
            return {"loss": out["loss"], "loss_pos": out["loss_pos"], "loss_v": out["loss_v"],
                    "pred_v": out["pred_ligand_v"]}
        start, stop = row_range(B, mesh)
        draws = [d[start:stop] for d in global_draws(model, batch, generator, t)]
        local = shard_rows(batch, mesh, even=False)
        sums = torch.zeros(3, device=batch.device)
        pred_v = torch.zeros(local.ligand_v.shape + (model.num_classes,), device=batch.device)
        if stop > start:  # a last batch of fewer rows than ranks leaves some ranks none
            out = model.get_diffusion_loss(local, *draws, impl=impl)
            sums = torch.stack([out[k] for k in ("loss", "loss_pos", "loss_v")]) * (stop - start)
            pred_v = out["pred_ligand_v"]
        loss, loss_pos, loss_v = (all_reduce_sum(sums, mesh) / B).unbind()
        return {"loss": loss, "loss_pos": loss_pos, "loss_v": loss_v,
                "pred_v": gather_rows(pred_v, B, mesh)}

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
