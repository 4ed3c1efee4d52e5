"""2D/3D convolution and transposed convolution with reference (PyTorch)
semantics (counterpart of cdlnet_tpu/ops/conv.py).

Weights keep the torch layout:
  conv2d/conv3d:                     (out_ch, in_ch, *kernel) — cross-correlation
  conv_transpose2d/conv_transpose3d: (in_ch, out_ch, *kernel) — gradient of conv
The reference always uses padding (P-1)//2 (2D) or P//2 per dim (3D) and
output_padding=s-1, which makes the synthesis the exact adjoint of the
analysis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """(N, C, H, W) x (M, C, kh, kw) -> (N, M, H', W'), torch Conv2d."""
    return F.conv2d(x, w, stride=stride, padding=padding)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
                     output_padding=0) -> torch.Tensor:
    """(N, M, H, W) x (M, C, kh, kw) -> (N, C, sH, sW), torch
    ConvTranspose2d."""
    return F.conv_transpose2d(
        x, w, stride=stride, padding=padding, output_padding=output_padding
    )


def conv3d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """(N, C, D, H, W) x (M, C, kd, kh, kw) -> (N, M, ...), torch Conv3d."""
    return F.conv3d(x, w, stride=stride, padding=padding)


def conv_transpose3d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
                     output_padding=0) -> torch.Tensor:
    """(N, M, D, H, W) x (M, C, kd, kh, kw) -> (N, C, ...), torch
    ConvTranspose3d."""
    return F.conv_transpose3d(
        x, w, stride=stride, padding=padding, output_padding=output_padding
    )
