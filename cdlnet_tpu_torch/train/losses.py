"""Training losses (counterpart of the mse half of
cdlnet_tpu/train/losses.py; ssim, the combined/VGG loss and MC-SURE are
still to be ported, see ROADMAP.md)."""

from __future__ import annotations

import math

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr_from_mse(mse: float) -> float:
    return -10.0 * math.log10(max(float(mse), 1e-30))
