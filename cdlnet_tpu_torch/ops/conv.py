"""3D convolution / transposed convolution with reference (PyTorch)
semantics (counterpart of cdlnet_tpu/ops/conv.py, 3D half).

Weights keep the torch layout:
  conv3d:           (out_ch, in_ch, kD, kH, kW)  — cross-correlation
  conv_transpose3d: (in_ch, out_ch, kD, kH, kW)  — gradient of conv3d
The reference always uses padding P//2 per dim and output_padding=s-1,
which makes the synthesis the exact adjoint of the analysis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
