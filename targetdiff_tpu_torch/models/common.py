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


class Swish(nn.Module):
    """x * sigmoid(beta * x) with a learnable beta (reference:
    models/common.py:41-47; targetdiff_tpu/models/common.py:26-32). beta is
    float32, so under a bf16 model the result is float32, as JAX promotes
    bf16 * float32."""

    def __init__(self):
        super().__init__()
        self.beta = nn.Parameter(torch.tensor(1.0))

    def forward(self, x):
        x = x.to(torch.promote_types(x.dtype, self.beta.dtype))
        return x * torch.sigmoid(self.beta * x)


_ACTIVATIONS = {"tanh": nn.Tanh, "relu": nn.ReLU, "softplus": nn.Softplus, "elu": nn.ELU,
                "silu": nn.SiLU, "swish": Swish}
ACTIVATIONS = tuple(sorted(_ACTIVATIONS))


def get_activation(name: str) -> nn.Module:
    """The activation module of `name` (targetdiff_tpu/models/common.py:35)."""
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r} (have {list(ACTIVATIONS)})")
    return _ACTIVATIONS[name]()


class MLP(nn.Module):
    """Linear -> [LayerNorm] -> act, num_layer - 1 times, then Linear, and
    with act_last a [LayerNorm] -> act after it (reference:
    models/common.py:60-80). The defaults are the released MLP. One
    activation module serves every position, as flax's MLP creates one (a
    swish MLP has one beta, `Swish_0` there). model_dtype is the model
    dtype (ops/precision.py model_linear): torch.bfloat16 runs the MLP as
    JAX's MLP(dtype=jnp.bfloat16)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int, num_layer: int = 2,
                 norm: bool = True, act_fn: str = "relu", act_last: bool = False,
                 model_dtype=torch.float32):
        super().__init__()
        self.model_dtype = precision.check_dtype(model_dtype)
        act = get_activation(act_fn)
        layers = []
        for i in range(num_layer):
            width = hidden_dim if i < num_layer - 1 else out_dim
            layers.append(nn.Linear(in_dim if i == 0 else hidden_dim, width))
            if i < num_layer - 1 or act_last:
                if norm:
                    layers.append(nn.LayerNorm(width))
                layers.append(act)
        self.net = nn.Sequential(*layers)

    def forward(self, x, dtype=torch.float32):
        """dtype=torch.bfloat16: each Linear's input and weight rounded to
        bf16, the product in float32 (ops/precision.py linear: the plain
        version of the bf16 kernels). A bf16 model ignores dtype."""
        if self.model_dtype != torch.float32:
            return precision.model_sequential(self.net, x, self.model_dtype)
        if dtype == torch.float32:
            return self.net(x)
        for m in self.net:
            x = precision.linear(x, m, dtype) if isinstance(m, nn.Linear) else m(x)
        return x


def outer_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., A] x [..., B] -> [..., A*B], a-major (reference: models/common.py:83-90)."""
    out = a[..., :, None] * b[..., None, :]
    return out.reshape(out.shape[:-2] + (a.shape[-1] * b.shape[-1],))
