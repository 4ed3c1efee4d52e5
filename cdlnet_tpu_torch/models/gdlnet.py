"""GDLNet: CDLNet with Gabor-parameterized filterbanks (counterpart of
cdlnet_tpu/models/gdlnet.py).

Every filter is synthesized from raw Gabor parameters (alpha, a, w0, psi)
as a mixture over `order` components, with optional parameter sharing
across iterations; the forward then runs the same 2D LISTA path as CDLNet
(models/cdlnet.py::lista2d_forward). Two reference behaviors kept as the
JAX package keeps them: analysis and synthesis of a bank use the same
synthesized filter, and alpha is never shared into the final dictionary
B[0] (with "alpha" in shared, A uses one alpha for all k, while B keeps
B[0]'s own alpha and shares a second one across k >= 1).

Parameter layout (per bank X in {A, B}, name in {alpha, a, w0, psi}), under
the JAX package's flat params names X_name:
  not shared:       X_name: (K, order, M, C, ...)
  shared non-alpha: X_name: (order, M, C, ...)
  shared alpha:     A_alpha: (order, M, C, 1, 1);  B_alpha: (2, order, M, C, 1, 1)
                    with B_alpha[0] for k=0 and B_alpha[1] for k>=1.
and t: (K, 2, M, 1, 1).
"""

from __future__ import annotations

import torch
from torch import nn

from cdlnet_tpu_torch.core.gabor import gabor_kernel
from cdlnet_tpu_torch.models.base import check_backend, register
from cdlnet_tpu_torch.models.cdlnet import (
    lista2d_forward,
    lista2d_with_codes,
    normalizing_scale,
)

_NAMES = ("alpha", "a", "w0", "psi")


@register("GDLNet")
class GDLNet(nn.Module):
    def __init__(self, K: int = 3, M: int = 64, P: int = 7, s: int = 1,
                 C: int = 1, t0: float = 0.0, order: int = 1,
                 adaptive: bool = False, shared: str = "",
                 backend: str = "xla"):
        super().__init__()
        check_backend(backend)
        self.K, self.M, self.P, self.s, self.C = K, M, P, s, C
        self.t0, self.order, self.adaptive = t0, order, adaptive
        self.shared, self.backend = shared, backend
        self.t = nn.Parameter(torch.zeros(K, 2, M, 1, 1))
        for bank in ("A", "B"):
            for name, base in self._base_shapes().items():
                setattr(self, f"{bank}_{name}",
                        nn.Parameter(torch.zeros(self._stored_shape(bank, name, base))))

    @property
    def pad(self) -> int:
        return (self.P - 1) // 2

    def _base_shapes(self) -> dict:
        o, M, C = self.order, self.M, self.C
        return {"alpha": (o, M, C, 1, 1), "a": (o, M, C, 2), "w0": (o, M, C, 2),
                "psi": (o, M, C)}

    def _is_shared(self, name: str) -> bool:
        # reference flags: substring match on "alpha", "a_", "w0", "psi"
        return ("a_" if name == "a" else name) in self.shared

    def _stored_shape(self, bank: str, name: str, base: tuple) -> tuple:
        if not self._is_shared(name):
            return (self.K, *base)
        if name == "alpha" and bank == "B":
            return (2, *base)
        return base

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None, init: bool = True):
        """Fill the parameters: one random draw of each Gabor parameter,
        repeated over k (and both banks); when `init`, every stored alpha
        is scaled once by 1/sqrt of the largest eigenvalue of B_0^T A_0
        (power method); t = t0. Random numbers come from `generator` on the
        CPU. Returns self."""
        dev = self.t.device
        for name, base in self._base_shapes().items():
            v = torch.randn(base, generator=generator).to(dev)
            for bank in ("A", "B"):
                p = getattr(self, f"{bank}_{name}")
                p.copy_(v.expand_as(p))
        if init:
            A_f, B_f = self.get_filters()
            scale = normalizing_scale(A_f[0], B_f[0], self.C, self.s, self.pad,
                                      generator, dev)
            self.A_alpha.mul_(scale)
            self.B_alpha.mul_(scale)
        self.t.fill_(self.t0)
        return self

    @torch.no_grad()
    def project(self):
        """In place: t >= 0 only; the Gabor parameterization itself bounds
        the filters."""
        self.t.clamp_(min=0.0)
        return self

    def _per_k(self, bank: str, name: str) -> torch.Tensor:
        """(K, order, M, C, ...) for a possibly shared parameter."""
        v = getattr(self, f"{bank}_{name}")
        if not self._is_shared(name):
            return v
        if name == "alpha" and bank == "B":
            rest = v[1][None].expand(max(self.K - 1, 0), *v[1].shape)
            return torch.cat([v[0][None], rest], dim=0)
        return v[None].expand(self.K, *v.shape)

    def get_filters(self):
        """The synthesized filterbanks (A_filt, B_filt): (K, M, C, P, P)."""
        out = []
        for bank in ("A", "B"):
            alpha, a, w0, psi = (self._per_k(bank, n) for n in _NAMES)
            out.append(torch.sum(alpha * gabor_kernel(a, w0, psi, self.P), dim=1))
        return tuple(out)

    def forward(self, y, sigma=None, mask=None, return_z=False):
        """Denoise batch y (N, C, H, W), as CDLNet.forward, with the banks
        synthesized from the Gabor parameters."""
        A_f, B_f = self.get_filters()
        return lista2d_forward(self, A_f, B_f, self.t, y, sigma, mask, return_z)

    def apply_with_codes(self, y, sigma=None, mask=None):
        """forward() that also returns every iteration's codes: (xhat, z,
        codes), codes (K, N, M, H/s, W/s) (models/cdlnet.py::
        lista2d_with_codes)."""
        A_f, B_f = self.get_filters()
        return lista2d_with_codes(self, A_f, B_f, self.t, y, sigma, mask)
