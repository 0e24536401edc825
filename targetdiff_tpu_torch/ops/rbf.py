"""Gaussian-smearing distance features, counterpart of targetdiff_tpu/ops/rbf.py
(reference: models/common.py:7-26)."""

from __future__ import annotations

import numpy as np
import torch

# Hand-tuned RBF knots (reference: models/common.py:15)
FIXED_OFFSETS = np.array(
    [0, 1, 1.25, 1.5, 1.75, 2, 2.25, 2.5, 2.75, 3, 3.5, 4, 4.5, 5, 5.5, 6, 7, 8, 9, 10],
    dtype=np.float32,
)


_OFFSETS = {}  # the knots' tensor on each device, copied there once


def gaussian_smearing_offsets(device="cpu"):
    """The fixed knots as a tensor and coeff = -0.5/(o[1]-o[0])^2; like the
    reference, the released model uses these whatever its r_max. The tensor
    is made once per device and shared (read only): a copy to the card per
    call would wait for the host each time."""
    coeff = -0.5 / float(FIXED_OFFSETS[1] - FIXED_OFFSETS[0]) ** 2
    key = torch.device(device)
    if key.type == "cuda" and key.index is None:
        key = torch.device("cuda", torch.cuda.current_device())
    if key not in _OFFSETS:
        _OFFSETS[key] = torch.as_tensor(FIXED_OFFSETS, device=key)
    return _OFFSETS[key], coeff


def gaussian_smearing(dist: torch.Tensor, offsets: torch.Tensor, coeff: float) -> torch.Tensor:
    """dist [...] -> [..., G] Gaussian RBF features."""
    d = dist[..., None] - offsets
    return torch.exp(coeff * d * d)
