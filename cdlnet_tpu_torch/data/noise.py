"""Noise injection and observation masks for image and video batches, on
the batch's device (counterpart of cdlnet_tpu/data/noise.py).

Reference semantics (utils.py:13-55): AWGN with sigma fixed or per-sample
uniform in [lo, hi] (on the [0,255] scale, applied /255); RGGB Bayer masks.
Random numbers come from an explicit torch.Generator on the batch's device;
they are not jax.random's, so parity tests feed both packages the same
noise arrays.
"""

from __future__ import annotations

import torch


def _awgn(x: torch.Tensor, noise_std, generator):
    if isinstance(noise_std, (list, tuple)):
        lo, hi = noise_std[0], noise_std[1]
        u = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=generator,
                       device=x.device, dtype=x.dtype)
        sigma = lo + (hi - lo) * u
    elif isinstance(noise_std, torch.Tensor):
        sigma = noise_std.to(x.device, x.dtype)
    else:  # filled on the device: no host copy in a captured step
        sigma = torch.full((), float(noise_std), dtype=x.dtype, device=x.device)
    noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return x + noise * (sigma / 255.0), sigma


def awgn(x: torch.Tensor, noise_std, generator: torch.Generator | None = None):
    """AWGN for (N, C, H, W). Returns (noisy, sigma): sigma is (N, 1, 1, 1),
    uniform in [noise_std[0], noise_std[1]], when noise_std is a range (only
    its first two entries are read, as in the reference), else a 0-dim
    tensor."""
    return _awgn(x, noise_std, generator)


def awgn3d(x: torch.Tensor, noise_std, generator: torch.Generator | None = None):
    """AWGN for (N, C, D, H, W). Returns (noisy, sigma): sigma is (N, 1, 1,
    1, 1), uniform in [noise_std[0], noise_std[1]], when noise_std is a
    range (only its first two entries are read, as in the reference), else
    a 0-dim tensor."""
    return _awgn(x, noise_std, generator)


def gen_bayer_mask(x: torch.Tensor) -> torch.Tensor:
    """RGGB mask for (N, 3, H, W) color batches (utils.py:13-19)."""
    m = torch.zeros_like(x)
    m[:, 0, 0::2, 0::2] = 1  # R
    m[:, 1, 0::2, 1::2] = 1  # G1
    m[:, 1, 1::2, 0::2] = 1  # G2
    m[:, 2, 1::2, 1::2] = 1  # B
    return m


def gen_bayer_mask3d(x: torch.Tensor) -> torch.Tensor:
    """Bayer mask for (N, C, D, H, W) video batches.

    The reference's version (utils.py:21-27) sets every pixel of every
    channel to 1, so 3D demosaicing is wired off; this replicates that."""
    return torch.ones_like(x)
