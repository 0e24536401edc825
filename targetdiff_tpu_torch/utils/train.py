"""Optimizer and learning-rate schedules, counterpart of
targetdiff_tpu/utils/train.py (reference: utils/train.py:55-101,
utils/warmup.py:28-86).

`get_optimizer` builds torch.optim.Adam (AdamW with weight decay) behind
global-norm clipping, the update of the JAX package's
optax.clip_by_global_norm -> adam chain. The schedulers are host objects
that return a learning rate, which `set_learning_rate` writes into the
optimizer between steps.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class ClippedOptimizer:
    """A torch optimizer whose step first clips the gradients' global norm
    to `max_grad_norm` (None: no clipping) and returns that norm before
    clipping."""

    def __init__(self, optimizer: torch.optim.Optimizer, max_grad_norm: Optional[float]):
        self.optimizer = optimizer
        self.max_grad_norm = max_grad_norm

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        params = [p for g in self.param_groups for p in g["params"] if p.grad is not None]
        if self.max_grad_norm:
            norm = torch.nn.utils.clip_grad_norm_(params, self.max_grad_norm)
        else:
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad)
                                                         for p in params]))
        self.optimizer.step()
        return norm

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state):
        self.optimizer.load_state_dict(state)


def get_optimizer(cfg, params) -> ClippedOptimizer:
    """Adam with optional decoupled weight decay and global-norm clipping
    (reference: utils/train.py:55-64; the clip at
    scripts/train_diffusion.py:136)."""
    if cfg.type != "adam":
        raise NotImplementedError(f"Optimizer not supported: {cfg.type}")
    betas = (cfg.beta1, cfg.beta2)
    if cfg.get("weight_decay", 0):
        opt = torch.optim.AdamW(params, lr=cfg.lr, betas=betas, eps=1e-8,
                                weight_decay=cfg.weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=cfg.lr, betas=betas, eps=1e-8)
    return ClippedOptimizer(opt, cfg.get("max_grad_norm", None))


def set_learning_rate(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class PlateauScheduler:
    """ReduceLROnPlateau with torch semantics (factor, patience, min_lr)
    (reference: utils/train.py:67-74 'plateau')."""

    def __init__(self, factor=0.6, patience=10, min_lr=1e-6, initial_lr=None):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.lr = initial_lr
        self.best: Optional[float] = None
        self.num_bad = 0

    def step(self, metric: float, lr: Optional[float] = None) -> float:
        """Feed a validation metric; returns the (possibly reduced) lr."""
        if lr is not None:
            self.lr = lr
        if self.best is None or metric < self.best:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self):
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d):
        self.lr, self.best, self.num_bad = d["lr"], d["best"], d["num_bad"]


class WarmupPlateauScheduler(PlateauScheduler):
    """Gradual warmup for `total_epoch` validation steps, then plateau
    (reference: utils/train.py:75-86 'warmup_plateau' + utils/warmup.py:28-86).
    multiplier > 1 scales base lr; lr ramps linearly to multiplier * base_lr.
    """

    def __init__(self, multiplier=2.0, total_epoch=10, base_lr=1e-4, **kw):
        super().__init__(initial_lr=base_lr, **kw)
        self.multiplier = multiplier
        self.total_epoch = total_epoch
        self.base_lr = base_lr
        self.epoch = 0

    def step(self, metric: float, lr: Optional[float] = None) -> float:
        self.epoch += 1
        if self.epoch <= self.total_epoch:
            frac = self.epoch / self.total_epoch
            self.lr = self.base_lr * ((self.multiplier - 1.0) * frac + 1.0)
            return self.lr
        return super().step(metric)


class ExpMinScheduler:
    """Exponential decay with a floor: lr_t = max(base * gamma^t, min_lr),
    stepping per validation call (reference: utils/train.py:12-30, :87-97
    'expmin'/'expmin_milestone')."""

    def __init__(self, base_lr, factor, min_lr, milestone=0):
        self.base_lr = base_lr
        self.factor = factor
        self.min_lr = min_lr
        self.milestone = milestone
        self.epoch = 0
        self.lr = base_lr

    def step(self, metric: float = None, lr: Optional[float] = None) -> float:
        self.epoch += 1
        e = max(self.epoch - self.milestone, 0)
        self.lr = max(self.base_lr * (self.factor**e), self.min_lr)
        return self.lr

    def state_dict(self):
        return {"epoch": self.epoch, "lr": self.lr}

    def load_state_dict(self, d):
        self.epoch, self.lr = d["epoch"], d["lr"]


def get_scheduler(cfg, optimizer_cfg):
    """(reference: utils/train.py:67-101)."""
    t = cfg.type
    if t == "plateau":
        return PlateauScheduler(
            factor=cfg.factor, patience=cfg.patience, min_lr=cfg.min_lr,
            initial_lr=optimizer_cfg.lr,
        )
    if t == "warmup_plateau":
        return WarmupPlateauScheduler(
            multiplier=cfg.multiplier, total_epoch=cfg.total_epoch, base_lr=optimizer_cfg.lr,
            factor=cfg.factor, patience=cfg.patience, min_lr=cfg.min_lr,
        )
    if t == "expmin":
        return ExpMinScheduler(base_lr=optimizer_cfg.lr, factor=cfg.factor, min_lr=cfg.min_lr)
    if t == "expmin_milestone":
        gamma = math.exp(math.log(cfg.factor) / cfg.milestone)
        return ExpMinScheduler(
            base_lr=optimizer_cfg.lr, factor=gamma, min_lr=cfg.min_lr
        )
    raise NotImplementedError(f"Scheduler not supported: {t}")
