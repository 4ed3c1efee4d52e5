"""MAD (median absolute deviation) blind noise-level estimator (counterpart
of cdlnet_tpu/nle/mad.py).

sigma_hat = median(|HH y|) / 0.6745 per image, where HH is the bior4.4
highest-frequency 2D subband filter applied to each channel with stride 2
and no padding. Runs on the batch's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cdlnet_tpu_torch.core.wavelet import filter_bank_2d


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of each row of a 2D tensor, the mean of the two middle values
    when the count is even (as numpy and jnp.median; torch.median takes
    the lower one)."""
    v = torch.sort(x, dim=1).values
    n = v.shape[1]
    return 0.5 * (v[:, (n - 1) // 2] + v[:, n // 2])


def nle_mad(y: torch.Tensor) -> torch.Tensor:
    """y: (N, C, H, W) in [0,1]. Returns sigma_hat (N, 1, 1, 1) on the [0,1]
    scale."""
    Wa, _ = filter_bank_2d("bior4.4")
    C = y.shape[1]
    hh = torch.from_numpy(Wa[3:4].copy()).to(y.device, y.dtype)  # (1, 1, 10, 10)
    HHy = F.conv2d(y, hh.expand(C, 1, *hh.shape[2:]), stride=2, groups=C)
    sigma = median(HHy.abs().reshape(y.shape[0], -1)) / 0.6745
    return sigma.reshape(-1, 1, 1, 1)
