"""CDLNet: 2D convolutional dictionary learning network (counterpart of
cdlnet_tpu/models/cdlnet.py).

K unrolled LISTA iterations with per-iteration analysis conv A_k (C->M,
stride s) and synthesis conv-transpose B_k (M->C), noise-adaptive
thresholds tau_k = t[k,0] + (sigma/255) t[k,1], final synthesis through
D = B[0]. JDD (joint demosaicing + denoising) is this model with C=3 and a
Bayer mask passed to forward().

Parameters, under the JAX package's params names:
  A, B: (K, M, C, P, P) analysis (Conv2d) / synthesis (ConvTranspose2d)
        weights; t, g: (K, 2, M, 1, 1) thresholds and the reference's unused
        g (kept so checkpoints load strictly).
"""

from __future__ import annotations

import torch
from torch import nn

from cdlnet_tpu_torch.core.ops import uball_project
from cdlnet_tpu_torch.core.preprocess import post_process, pre_process
from cdlnet_tpu_torch.core.solvers import power_method
from cdlnet_tpu_torch.kernels.autodiff import RETURN_Z_HINT, lista2d_fused_diff
from cdlnet_tpu_torch.kernels.lista2d import lista2d_fused
from cdlnet_tpu_torch.models.base import check_backend, register, sigma_scale
from cdlnet_tpu_torch.ops.conv import conv2d, conv_transpose2d
from cdlnet_tpu_torch.ops.lista import lista_2d


def lista2d_forward(model, A, B, t, y, sigma, mask, return_z):
    """The 2D LISTA denoiser forward shared by CDLNet and GDLNet: pre-process
    y (N, C, H, W), the K-iteration loop with banks A, B and thresholds t on
    the kernels (backend "pallas"/"cuda") or the plain loop ("xla"), the
    final synthesis through B[0], and post-process. Returns (xhat, z or
    None). On the kernels with gradients enabled the forward is
    lista2d_fused_diff (kernel forward with histories, the reverse kernels
    as its backward; JAX's apply(train=True)); return_z=True then raises,
    since the code output has no gradient."""
    yp, prm, mask, c = _prepare(model, y, sigma, mask)
    if model.backend in ("pallas", "cuda") and torch.is_grad_enabled():
        if return_z:
            raise NotImplementedError(RETURN_Z_HINT)
        xphat = lista2d_fused_diff(yp, A, B, t, c, stride=model.s, mask=mask)
        z = None
    elif model.backend in ("pallas", "cuda"):
        xphat, z = lista2d_fused(yp, A, B, t, c, stride=model.s, mask=mask,
                                 return_z=return_z)
    else:
        z = lista_2d(yp, A, B, t, c, mask=mask, stride=model.s)
        xphat = conv_transpose2d(z, B[0], stride=model.s, padding=model.pad,
                                 output_padding=model.s - 1)
    return post_process(xphat, prm), (z if return_z else None)


def _prepare(model, y, sigma, mask):
    """(yp, pre_process params, mask, c): the pre-processed input and the
    threshold scale on its device."""
    yp, prm, mask = pre_process(y, model.s, mask=mask)
    c = sigma_scale(sigma, model.adaptive, 4)
    if isinstance(c, torch.Tensor):
        c = c.to(yp.device, yp.dtype)
    return yp, prm, mask, c


def lista2d_with_codes(model, A, B, t, y, sigma, mask):
    """lista2d_forward that also returns every iteration's codes: (xhat, z,
    codes), codes (K, N, M, H/s, W/s) with codes[-1] == z (the reference's
    forward_generator, model/net.py:94-104). On backend "pallas"/"cuda"
    the codes are the z histories the kernel loop writes for training
    (lista2d_loop(return_hists=True)), in fp32 whatever hist_dtype() says,
    from the 2K launches of one forward;
    with gradients enabled that raises, as forward(return_z=True) does.
    Backend "xla" runs the plain loop."""
    yp, prm, mask, c = _prepare(model, y, sigma, mask)
    if model.backend in ("pallas", "cuda"):
        if torch.is_grad_enabled():
            raise NotImplementedError(RETURN_Z_HINT)
        xphat, z, (codes, _) = lista2d_fused(yp, A, B, t, c, stride=model.s, mask=mask,
                                             return_z=True, return_hist=True,
                                             hists_dtype=torch.float32)
    else:
        z, codes = lista_2d(yp, A, B, t, c, mask=mask, stride=model.s, return_codes=True)
        xphat = conv_transpose2d(z, B[0], stride=model.s, padding=model.pad,
                                 output_padding=model.s - 1)
    return post_process(xphat, prm), z, codes


def normalizing_scale(A0, B0, C, s, pad, generator, dev):
    """1/sqrt(L), L the largest eigenvalue of B0^T A0 (the power method, 200
    iterations on a (1, C, 128, 128) probe drawn from `generator`)."""
    def DDt(x):
        return conv_transpose2d(conv2d(x, A0, stride=s, padding=pad), B0,
                                stride=s, padding=pad, output_padding=s - 1)

    b0 = torch.rand(1, C, 128, 128, generator=generator)
    L, _, _ = power_method(DDt, b0.to(dev), num_iter=200)
    return 1.0 / torch.sqrt(L)


@register("CDLNet")
class CDLNet(nn.Module):
    # parameters the forward never reads: training gives them a zero
    # gradient (train.fit.train_update), as jax.grad does
    unused_params = ("g",)

    def __init__(self, K: int = 3, M: int = 64, P: int = 7, s: int = 1,
                 C: int = 1, t0: float = 0.0, adaptive: bool = False,
                 backend: str = "xla"):
        super().__init__()
        check_backend(backend)
        self.K, self.M, self.P, self.s, self.C = K, M, P, s, C
        self.t0, self.adaptive, self.backend = t0, adaptive, backend
        self.A = nn.Parameter(torch.zeros(K, M, C, P, P))
        self.B = nn.Parameter(torch.zeros(K, M, C, P, P))
        self.t = nn.Parameter(torch.zeros(K, 2, M, 1, 1))
        self.g = nn.Parameter(torch.zeros(K, 2, M, 1, 1))

    @property
    def pad(self) -> int:
        return (self.P - 1) // 2

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None, init: bool = True):
        """Fill the parameters: one random filter bank W shared by every A_k
        and B_k, spectrally normalized by the power method when `init`, and
        t = g = t0. Random numbers come from `generator` on the CPU, so a
        seed gives the same weights on every device. Returns self."""
        dev = self.A.device
        W = torch.randn(self.M, self.C, self.P, self.P, generator=generator).to(dev)
        if init:
            W = W * normalizing_scale(W, W, self.C, self.s, self.pad, generator, dev)
        self.A.copy_(W.expand_as(self.A))
        self.B.copy_(W.expand_as(self.B))
        self.t.fill_(self.t0)
        self.g.fill_(self.t0)
        return self

    @torch.no_grad()
    def project(self):
        """In place: t >= 0 and each (k, m, c) filter on the l2 unit ball
        over (kH, kW), as the JAX package's project() does."""
        self.t.clamp_(min=0.0)
        self.A.copy_(uball_project(self.A, axes=(3, 4)))
        self.B.copy_(uball_project(self.B, axes=(3, 4)))
        return self

    def forward(self, y, sigma=None, mask=None, return_z=False):
        """Denoise batch y (N, C, H, W); sigma a scalar or one per image on
        the [0, 255] scale; mask an optional (N, C, H, W) observation mask
        (JDD). Returns (xhat, z), z the final codes (N, M, H/s, W/s) when
        return_z, else None."""
        return lista2d_forward(self, self.A, self.B, self.t, y, sigma, mask,
                               return_z)

    def apply_with_codes(self, y, sigma=None, mask=None):
        """forward() that also returns every iteration's codes: (xhat, z,
        codes), codes (K, N, M, H/s, W/s) (lista2d_with_codes)."""
        return lista2d_with_codes(self, self.A, self.B, self.t, y, sigma, mask)
