"""The denoiser's precisions: float32, or bf16, the JAX package's default for
sampling (targetdiff_tpu/models/score_model.py sample_diffusion(dtype=
jnp.bfloat16)) and its bf16 training variant (get_diffusion_loss(impl=
'fast_bf16' | 'fast_bf16_pl')).

bf16 rounds the operands of every dense product of the attention layers and
of the edge-weight MLP to bf16 (activations and weights) and multiplies them
in float32: exact products, float32 sums, as a tensor-core product with
float32 accumulation. Biases, LayerNorm, softmax, geometry, the residual h
and the positions stay float32. The embeddings and the type head run in
float32 in both, as in the JAX fast path.

Training (`Bf16Linear`, JAX's targetdiff_tpu/ops/pallas/edge_layer_vjp.py
_cdot / _cdotg at cd=bf16) rounds in both directions: the input gradient
round(dY) round(W) and the weight gradient round(dY)^T round(X), both in
float32 and never rounded after the product, so parameters, their
gradients and the optimizer stay float32. Its training path keeps the
edge-weight MLP float32, as JAX's fast_train_forward.

The model dtype is another thing: JAX's `DiffusionModel(dtype=jnp.bfloat16)`,
the eager network run in bf16 (`model_linear`, `model_layer_norm`; the
port's `DiffusionModel(model_dtype=torch.bfloat16)`). There a Linear
returns a bf16 result, its bias added in bf16, a LayerNorm computes in
float32 and returns bf16, and the activations, softmax and residual h
between them are bf16 tensors, as targetdiff_tpu/models/common.py
TorchLinear and LayerNorm with dtype=bf16. Parameters stay float32;
autograd rounds their gradients' products to bf16 as JAX's bf16 model does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(dtype) -> torch.dtype:
    """`dtype` if the denoiser takes it, else ValueError."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype!r}")
    return dtype


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest even), back in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _product(kind, a, b):
    """a @ b, float32 operands already rounded to bf16: `Bf16Linear`'s
    products, `kind` 'forward', 'input_grad' or 'weight_grad'."""
    return a @ b


class Bf16Linear(torch.autograd.Function):
    """y = round(x) round(W)^T + b, differentiable with bf16 products in both
    directions: dx = round(dy) round(W), dW = round(dy)^T round(x) (summed
    over every leading axis), db = the float32 sum of dy. Every result is
    float32."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xr, wr = round_bf16(x), round_bf16(weight)
        ctx.save_for_backward(xr, wr)
        ctx.has_bias = bias is not None
        y = _product("forward", xr, wr.T)
        return y + bias if bias is not None else y

    @staticmethod
    def backward(ctx, dy):
        xr, wr = ctx.saved_tensors
        dyr = round_bf16(dy)
        dx = _product("input_grad", dyr, wr) if ctx.needs_input_grad[0] else None
        dw = db = None
        if ctx.needs_input_grad[1]:
            dw = _product("weight_grad", dyr.reshape(-1, dy.shape[-1]).T,
                          xr.reshape(-1, xr.shape[-1]))
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.reshape(-1, dy.shape[-1]).sum(0)
        return dx, dw, db


def linear(x: torch.Tensor, layer: torch.nn.Linear, dtype=torch.float32) -> torch.Tensor:
    """`layer(x)`; bf16: x and the weight rounded to bf16, the product in
    float32, the bias float32; where autograd records, as `Bf16Linear`
    (bf16 products backward too)."""
    if dtype == torch.float32:
        return layer(x)
    if torch.is_grad_enabled() and (x.requires_grad or layer.weight.requires_grad):
        return Bf16Linear.apply(x, layer.weight, layer.bias)
    return torch.nn.functional.linear(round_bf16(x), round_bf16(layer.weight), layer.bias)


def to_model(t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """t rounded to the model dtype where it is bf16; as it is for a float32
    model (so float64 copies of a float32 model stay float64)."""
    return t if dtype == torch.float32 else t.to(dtype)


def model_linear(x: torch.Tensor, layer: torch.nn.Linear, dtype=torch.float32) -> torch.Tensor:
    """`layer(x)` in the model dtype (targetdiff_tpu/models/common.py
    TorchLinear(dtype=...)): float32 is `layer(x)`; bf16 multiplies x and
    the weight rounded to bf16 into a bf16 result and adds the bias rounded
    to bf16, in bf16."""
    if dtype == torch.float32:
        return layer(x)
    y = x.to(dtype) @ layer.weight.to(dtype).T
    return y + layer.bias.to(dtype) if layer.bias is not None else y


def model_layer_norm(x: torch.Tensor, norm: torch.nn.LayerNorm,
                     dtype=torch.float32) -> torch.Tensor:
    """`norm(x)` in the model dtype (targetdiff_tpu/models/common.py
    LayerNorm(dtype=...)): computed in float32 from x, returned in dtype."""
    if dtype == torch.float32:
        return norm(x)
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(dtype)


def model_sequential(seq: torch.nn.Sequential, x: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """`seq(x)` in the model dtype: its Linears as `model_linear`, its
    LayerNorms as `model_layer_norm`, every other module on what it is
    given."""
    if dtype == torch.float32:
        return seq(x)
    for m in seq:
        if isinstance(m, torch.nn.Linear):
            x = model_linear(x, m, dtype)
        elif isinstance(m, torch.nn.LayerNorm):
            x = model_layer_norm(x, m, dtype)
        else:
            x = m(x)
    return x
