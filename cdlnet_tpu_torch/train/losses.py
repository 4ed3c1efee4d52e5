"""Training losses and metrics (counterpart of the mse and ssim parts of
cdlnet_tpu/train/losses.py; the combined/VGG loss and MC-SURE are still to
be ported, see ROADMAP.md)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# the gaussian window of ssim: its size and standard deviation
SSIM_WIN = 11
SSIM_WIN_SIGMA = 1.5


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr_from_mse(mse: float) -> float:
    return -10.0 * math.log10(max(float(mse), 1e-30))


def _gaussian_window(like):
    x = torch.arange(SSIM_WIN, dtype=like.dtype, device=like.device) - (SSIM_WIN - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * SSIM_WIN_SIGMA**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(x, y, data_range=1.0):
    """Mean SSIM over an (N, C, H, W) batch: an 11x11 gaussian window of
    sigma 1.5 per channel, valid positions only, K1 = 0.01, K2 = 0.03 (the
    defaults of pytorch_msssim, which the reference's loss used)."""
    C = x.shape[1]
    win = _gaussian_window(x)
    w = win[None, None].expand(C, 1, SSIM_WIN, SSIM_WIN)

    def filt(v):
        return F.conv2d(v, w, groups=C)

    C1, C2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mu_x, mu_y = filt(x), filt(y)
    mu_x2, mu_y2, mu_xy = mu_x**2, mu_y**2, mu_x * mu_y
    # clamp residual negative variances from fp32 rounding
    sig_x = torch.clamp(filt(x * x) - mu_x2, min=0.0)
    sig_y = torch.clamp(filt(y * y) - mu_y2, min=0.0)
    sig_xy = filt(x * y) - mu_xy
    cs = (2 * sig_xy + C2) / (sig_x + sig_y + C2)
    ssim_map = ((2 * mu_xy + C1) / (mu_x2 + mu_y2 + C1)) * cs
    return torch.mean(ssim_map)
