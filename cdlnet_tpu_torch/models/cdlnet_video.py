"""CDLNetVideo: 3D spatiotemporal convolutional dictionary learning network
(counterpart of cdlnet_tpu/models/cdlnet_video.py).

The LISTA loop over Conv3d/ConvTranspose3d on (N, C, D, H, W) clips.
P is (kD, kH, kW) as nn.Conv3d reads it, so P=(7,7,5) means temporal
extent 7 and width extent 5; an int P is cubed.

Parameters, under the JAX package's params names:
  A, B: (K, M, C, kD, kH, kW) analysis (Conv3d) / synthesis
        (ConvTranspose3d, in=M, out=C) weights; t: (K, 2, M, 1, 1, 1);
  with residual=True also residual.conv1, residual.conv2: (K, M, M, 3, 3,
        3), the per-iteration residual blocks (ops/lista.py::res_block).

Residual blocks run on the plain F.conv3d loop on every backend: the hand
kernels fuse the threshold into the analysis and hold no residual block,
and the JAX package routes residual models to its XLA scan too
(cdlnet_tpu/models/cdlnet_video.py:126-127, 177-181). The configuration
chooses that route, so a kernel-backend model with residual blocks
launches no kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from cdlnet_tpu_torch.core.ops import uball_project
from cdlnet_tpu_torch.core.preprocess import post_process_3d, pre_process_3d
from cdlnet_tpu_torch.core.solvers import power_method
from cdlnet_tpu_torch.kernels.autodiff import RETURN_Z_HINT, lista3d_fused_diff
from cdlnet_tpu_torch.kernels.lista3d import lista3d_fused
from cdlnet_tpu_torch.models.base import check_backend, register, sigma_scale
from cdlnet_tpu_torch.ops.conv import conv3d, conv_transpose3d
from cdlnet_tpu_torch.ops.lista import lista_3d


@register("CDLNetVideo")
class CDLNetVideo(nn.Module):
    def __init__(self, K: int = 3, M: int = 64, P=(7, 7, 5), s: int = 1,
                 C: int = 1, t0: float = 0.0, adaptive: bool = False,
                 depth: int = 3, residual: bool = False, backend: str = "xla"):
        super().__init__()
        check_backend(backend)
        self.K, self.M, self.s, self.C = K, M, s, C
        self.P = (P,) * 3 if isinstance(P, int) else tuple(P)
        self.t0, self.adaptive, self.depth = t0, adaptive, depth
        self.backend = backend
        self.A = nn.Parameter(torch.zeros(K, M, C, *self.P))
        self.B = nn.Parameter(torch.zeros(K, M, C, *self.P))
        self.t = nn.Parameter(torch.zeros(K, 2, M, 1, 1, 1))
        self.residual = nn.ParameterDict({
            name: nn.Parameter(torch.zeros(K, M, M, 3, 3, 3)) for name in ("conv1", "conv2")
        }) if residual else None

    @property
    def pad(self):
        return (self.P[0] // 2, self.P[1] // 2, self.P[2] // 2)

    @property
    def on_kernels(self) -> bool:
        """Whether a forward runs the hand kernels: backend "pallas" or
        "cuda" and no residual blocks."""
        return self.backend in ("pallas", "cuda") and self.residual is None

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None, init: bool = True):
        """Fill the parameters: one random filter bank W shared by every
        A_k and B_k, spectrally normalized by the power method (200
        iterations of D D^T on a (1, C, depth, 128, 128) probe) when `init`,
        and t = t0; residual blocks get kaiming-style normal weights, std
        sqrt(2 / (27 M)). Random numbers come from `generator` on the CPU,
        so a seed gives the same weights on every device. Returns self."""
        dev = self.A.device
        W = torch.randn(self.M, self.C, *self.P, generator=generator).to(dev)
        if init:
            def DDt(x):
                return conv_transpose3d(
                    conv3d(x, W, stride=self.s, padding=self.pad), W,
                    stride=self.s, padding=self.pad, output_padding=self.s - 1,
                )

            b0 = torch.rand(1, self.C, self.depth, 128, 128, generator=generator)
            L, _, _ = power_method(DDt, b0.to(dev), num_iter=200)
            W = W / torch.sqrt(L)
        self.A.copy_(W.expand_as(self.A))
        self.B.copy_(W.expand_as(self.B))
        self.t.fill_(self.t0)
        if self.residual is not None:
            for w in self.residual.values():
                w.copy_(torch.randn(w.shape, generator=generator)
                        * (2.0 / (self.M * 27)) ** 0.5)
        return self

    @torch.no_grad()
    def project(self):
        """In place: t >= 0 and each (k, m, c) filter on the l2 unit ball
        over (kD, kH, kW), as the JAX package's project() does; residual
        blocks stay unconstrained."""
        self.t.clamp_(min=0.0)
        self.A.copy_(uball_project(self.A, axes=(3, 4, 5)))
        self.B.copy_(uball_project(self.B, axes=(3, 4, 5)))
        return self

    def forward(self, y, sigma=None, mask=None, return_z=False):
        """Denoise clip batch y (N, C, D, H, W). Returns (xhat, z), z the
        final codes (N, M, D/s, H/s, W/s) when return_z, else None.

        On the kernels (on_kernels) with gradients enabled the forward is
        lista3d_fused_diff (kernel forward with histories, the reverse
        kernels as its backward; JAX's apply(train=True)); return_z=True
        then raises, since the code output has no gradient."""
        yp, prm, mask = pre_process_3d(y, self.s, mask=mask)
        c = sigma_scale(sigma, self.adaptive, 5)
        if isinstance(c, torch.Tensor):
            c = c.to(yp.device, yp.dtype)
        if self.on_kernels and torch.is_grad_enabled():
            if return_z:
                raise NotImplementedError(RETURN_Z_HINT)
            xphat = lista3d_fused_diff(yp, self.A, self.B, self.t, c,
                                       stride=self.s, mask=mask)
            z = None
        elif self.on_kernels:
            xphat, z = lista3d_fused(yp, self.A, self.B, self.t, c,
                                     stride=self.s, mask=mask, return_z=return_z)
        else:
            z = lista_3d(yp, self.A, self.B, self.t, c, mask=mask, stride=self.s,
                         residual=self.residual)
            xphat = conv_transpose3d(z, self.B[0], stride=self.s, padding=self.pad,
                                     output_padding=self.s - 1)
        return post_process_3d(xphat, prm), (z if return_z else None)

    def apply_with_codes(self, y, sigma=None, mask=None):
        """forward() that also returns every iteration's codes: (xhat, z,
        codes), codes (K, N, M, D/s, H/s, W/s) with codes[-1] == z.

        On the kernels (on_kernels) the codes are the z histories the
        kernel loop writes for training (lista3d_loop(return_hists=True)),
        in fp32 whatever hist_dtype() says, so the 2K launches of one
        forward produce them; with gradients enabled that raises, as
        forward(return_z=True) does. Backend
        "xla" and residual blocks run the plain loop."""
        yp, prm, mask = pre_process_3d(y, self.s, mask=mask)
        c = sigma_scale(sigma, self.adaptive, 5)
        if isinstance(c, torch.Tensor):
            c = c.to(yp.device, yp.dtype)
        if self.on_kernels:
            if torch.is_grad_enabled():
                raise NotImplementedError(RETURN_Z_HINT)
            xphat, z, (codes, _) = lista3d_fused(yp, self.A, self.B, self.t, c,
                                                 stride=self.s, mask=mask,
                                                 return_hists=True,
                                                 hists_dtype=torch.float32)
        else:
            z, codes = lista_3d(yp, self.A, self.B, self.t, c, mask=mask, stride=self.s,
                                residual=self.residual, return_codes=True)
            xphat = conv_transpose3d(z, self.B[0], stride=self.s, padding=self.pad,
                                     output_padding=self.s - 1)
        return post_process_3d(xphat, prm), z, codes
