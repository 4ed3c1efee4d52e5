"""The MAD noise estimate: sigma_hat = median(|HH y|) / 0.6745 per image,
HH the bior4.4 wavelet's highest-frequency 2D subband, applied to each
channel with stride 2 and no padding (a true convolution), the median
over all of an image's coefficients, the mean of the two middle values
when their count is even."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference.lista import to_tf32

# the bior4.4 (CDF 9/7) analysis high-pass filter, as pywt aligns it
_DEC_HI = np.array([0.0, -0.06453888262869706, 0.04068941760916406, 0.41809227322161724,
                    -0.7884856164055829, 0.41809227322161724, 0.04068941760916406,
                    -0.06453888262869706, 0.0, 0.0])


def hh_filter() -> np.ndarray:
    """The HH subband as a correlation kernel (10, 10): the outer product
    of the high-pass filter with itself, flipped."""
    return np.outer(_DEC_HI, _DEC_HI)[::-1, ::-1].astype(np.float32)


def mad_sigma(y: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """y: (N, C, H, W). Returns sigma_hat (N,) on y's [0, 1] scale; tf32:
    the filter's operands rounded to TF32 (the control)."""
    C = y.shape[1]
    hh = torch.from_numpy(hh_filter().copy()).to(y.device, y.dtype)
    if tf32:
        y, hh = to_tf32(y), to_tf32(hh)
    coef = F.conv2d(y, hh.expand(C, 1, 10, 10), stride=2, groups=C)
    v = torch.sort(coef.abs().reshape(y.shape[0], -1), dim=1).values
    n = v.shape[1]
    return 0.5 * (v[:, (n - 1) // 2] + v[:, n // 2]) / 0.6745
