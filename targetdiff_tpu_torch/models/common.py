"""Shared building blocks, counterpart of targetdiff_tpu/models/common.py
(reference: models/common.py). Parameter names follow the reference so that
its state_dicts load unchanged: an MLP's modules sit in `net` in the
reference's nn.Sequential order, so the released MLP (num_layer 2, norm,
ReLU) is `net.0` (Linear), `net.1` (LayerNorm), `net.3` (Linear), and one
without norm is `net.0`, `net.2`."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import precision


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - log 2 (reference: models/common.py:156-162)."""
    return F.softplus(x) - math.log(2.0)


class ShiftedSoftplus(nn.Module):
    def forward(self, x):
        return shifted_softplus(x)


_ACTIVATIONS = {"tanh": nn.Tanh, "relu": nn.ReLU, "softplus": nn.Softplus, "elu": nn.ELU,
                "silu": nn.SiLU}


def get_activation(name: str) -> nn.Module:
    """The activation module of `name` (targetdiff_tpu/models/common.py:35;
    the learnable 'swish' is not ported)."""
    if name not in _ACTIVATIONS:
        raise NotImplementedError(f"activation {name!r} is not ported "
                                  f"(have {sorted(_ACTIVATIONS)})")
    return _ACTIVATIONS[name]()


class MLP(nn.Module):
    """Linear -> [LayerNorm] -> act, num_layer - 1 times, then Linear, and
    with act_last a [LayerNorm] -> act after it (reference:
    models/common.py:60-80). The defaults are the released MLP."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int, num_layer: int = 2,
                 norm: bool = True, act_fn: str = "relu", act_last: bool = False):
        super().__init__()
        layers = []
        for i in range(num_layer):
            width = hidden_dim if i < num_layer - 1 else out_dim
            layers.append(nn.Linear(in_dim if i == 0 else hidden_dim, width))
            if i < num_layer - 1 or act_last:
                if norm:
                    layers.append(nn.LayerNorm(width))
                layers.append(get_activation(act_fn))
        self.net = nn.Sequential(*layers)

    def forward(self, x, dtype=torch.float32):
        """dtype=torch.bfloat16: each Linear's input and weight rounded to
        bf16, the product in float32 (ops/precision.py)."""
        if dtype == torch.float32:
            return self.net(x)
        for m in self.net:
            x = precision.linear(x, m, dtype) if isinstance(m, nn.Linear) else m(x)
        return x


def outer_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., A] x [..., B] -> [..., A*B], a-major (reference: models/common.py:83-90)."""
    out = a[..., :, None] * b[..., None, :]
    return out.reshape(out.shape[:-2] + (a.shape[-1] * b.shape[-1],))
