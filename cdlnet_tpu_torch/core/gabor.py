"""Gabor filterbank synthesis from raw parameters (counterpart of
cdlnet_tpu/core/gabor.py).

h = exp(-||a * (x - x0)||^2) * cos(<w0, (x - x0)> + psi), evaluated on a
ks x ks grid centered at x0 = ((ks-1)/2, (ks-1)/2).
"""

from __future__ import annotations

import torch


def gabor_kernel(a: torch.Tensor, w0: torch.Tensor, psi: torch.Tensor,
                 ks: int) -> torch.Tensor:
    """Generate a batch of Gabor filters.

    a   (inverse width): (..., 2), e.g. (batch, oc, ic, 2)
    w0  (center freq):   (..., 2)
    psi (phase):         (...)
    returns h:           (..., ks, ks)
    """
    i = torch.arange(ks, dtype=a.dtype, device=a.device)
    # grid of (i, j) coordinates, shape (ks, ks, 2) with 'ij' indexing
    d = torch.stack(torch.meshgrid(i, i, indexing="ij"), dim=2) - (ks - 1) / 2.0
    a = a[..., None, None, :]
    w0 = w0[..., None, None, :]
    return torch.exp(-torch.sum((a * d) ** 2, dim=-1)) * torch.cos(
        torch.sum(w0 * d, dim=-1) + psi[..., None, None])
