"""Power method for the largest eigenvalue of a linear operator (counterpart
of cdlnet_tpu/core/solvers.py). Used at model init for the spectral
normalization of the initial dictionary."""

from __future__ import annotations

import torch


@torch.no_grad()
def power_method(A, b: torch.Tensor, num_iter: int = 1000, tol: float = 1e-6):
    """Estimate the max eigenvalue of linear operator A from initial vector b.

    A: callable tensor -> tensor. Stops early once successive estimates
    differ by less than tol. Returns (eig_max (0-d tensor), b_final,
    tol_reached).
    """
    eig_old = 0.0
    eig = torch.zeros((), dtype=b.dtype, device=b.device)
    tol_reached = False
    for _ in range(num_iter):
        b = A(b)
        b = b / torch.sqrt(torch.sum(b * b))
        eig = torch.sum(b * A(b))
        e = float(eig)
        if abs(e - eig_old) < tol:
            tol_reached = True
            break
        eig_old = e
    return eig, b, tol_reached
