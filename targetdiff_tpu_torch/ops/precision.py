"""The denoiser's precisions: float32, or bf16, the JAX package's default for
sampling (targetdiff_tpu/models/score_model.py sample_diffusion(dtype=
jnp.bfloat16)).

bf16 rounds the operands of every dense product of the attention layers and
of the edge-weight MLP to bf16 (activations and weights) and multiplies them
in float32: exact products, float32 sums, as a tensor-core product with
float32 accumulation. Biases, LayerNorm, softmax, geometry, the residual h
and the positions stay float32. The embeddings and the type head run in
float32 in both, as in the JAX fast path.
"""

from __future__ import annotations

import torch

DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(dtype) -> torch.dtype:
    """`dtype` if the denoiser takes it, else ValueError."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype!r}")
    return dtype


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest even), back in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def linear(x: torch.Tensor, layer: torch.nn.Linear, dtype=torch.float32) -> torch.Tensor:
    """`layer(x)`; bf16: x and the weight rounded to bf16, the product in
    float32, the bias float32."""
    if dtype == torch.float32:
        return layer(x)
    return torch.nn.functional.linear(round_bf16(x), round_bf16(layer.weight), layer.bias)
