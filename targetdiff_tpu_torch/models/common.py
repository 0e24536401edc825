"""Shared building blocks, counterpart of targetdiff_tpu/models/common.py
(reference: models/common.py). Parameter names follow the reference so that
its state_dicts load unchanged: MLP layers are `net.0` (Linear), `net.1`
(LayerNorm), `net.3` (Linear)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - log 2 (reference: models/common.py:156-162)."""
    return F.softplus(x) - math.log(2.0)


class ShiftedSoftplus(nn.Module):
    def forward(self, x):
        return shifted_softplus(x)


class MLP(nn.Module):
    """Linear -> LayerNorm -> ReLU -> Linear (reference: models/common.py:60-80
    with num_layer=2, norm=True, act_fn='relu')."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(in_dim, hidden_dim), nn.LayerNorm(hidden_dim), nn.ReLU(),
            nn.Linear(hidden_dim, out_dim),
        )

    def forward(self, x):
        return self.net(x)


def outer_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., A] x [..., B] -> [..., A*B], a-major (reference: models/common.py:83-90)."""
    out = a[..., :, None] * b[..., None, :]
    return out.reshape(out.shape[:-2] + (a.shape[-1] * b.shape[-1],))
