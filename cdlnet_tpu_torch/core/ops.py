"""Elementwise proximal operators and constraint projection (counterpart of
cdlnet_tpu/core/ops.py)."""

from __future__ import annotations

import torch


def ST(x: torch.Tensor, t) -> torch.Tensor:
    """Soft thresholding sign(x) * relu(|x| - t); t broadcasts against x."""
    return torch.sign(x) * torch.clamp(x.abs() - t, min=0.0)


def prox_csr(u, z_prev, lambd, gamma):
    """Proximal operator of the one-sided CSR temporal-consistency penalty:
    nested soft thresholds pulling the code u toward the neighbour frame's
    code z_prev (reference model/net.py:229-242). sign(0) = 0."""
    shift = z_prev + lambd * torch.sign(z_prev)
    return ST(ST(u - shift, lambd * gamma) + shift, lambd)


def csr_f2_jump(z_prev, z_after, lambd, gamma2):
    """Ca, the point where prox_csr_f2 jumps by up to 2 lambd gamma1 as u
    crosses it."""
    return z_prev + lambd * torch.sign(z_prev) + lambd * gamma2 * torch.sign(z_prev - z_after)


def prox_csr_f2(u, z_prev, z_after, lambd, gamma1, gamma2):
    """Two-sided CSR prox with the previous and following frames' codes
    (reference model/net.py:244-262). It jumps by up to 2 lambd gamma1 where
    u crosses Ca (csr_f2_jump), as the reference's does."""
    Ca = csr_f2_jump(z_prev, z_after, lambd, gamma2)
    Cb = z_after + lambd * torch.sign(z_after) + lambd * gamma1 * torch.sign(z_after - z_prev)
    inner = ST(u - Ca, gamma1 * lambd)
    corr = lambd * gamma1 * torch.sign(u - Ca)
    midder = ST(inner - Cb + corr, gamma2 * lambd)
    return ST(midder + Cb - corr, lambd)


def uball_project(W: torch.Tensor, axes=(2, 3)) -> torch.Tensor:
    """Project each filter of W onto the l2 unit ball over the given axes:
    W * min(1, 1/||W||) per filter."""
    normW = torch.sqrt(torch.sum(W * W, dim=axes, keepdim=True))
    return W * torch.clamp(1.0 / torch.clamp(normW, min=1e-30), max=1.0)
