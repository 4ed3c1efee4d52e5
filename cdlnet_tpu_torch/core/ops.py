"""Elementwise proximal operator and constraint projection (counterpart of
cdlnet_tpu/core/ops.py)."""

from __future__ import annotations

import torch


def ST(x: torch.Tensor, t) -> torch.Tensor:
    """Soft thresholding sign(x) * relu(|x| - t); t broadcasts against x."""
    return torch.sign(x) * torch.clamp(x.abs() - t, min=0.0)


def uball_project(W: torch.Tensor, axes=(2, 3)) -> torch.Tensor:
    """Project each filter of W onto the l2 unit ball over the given axes:
    W * min(1, 1/||W||) per filter."""
    normW = torch.sqrt(torch.sum(W * W, dim=axes, keepdim=True))
    return W * torch.clamp(1.0 / torch.clamp(normW, min=1e-30), max=1.0)
