"""Frame-recurrent CSR variants of CDLNet (counterpart of
cdlnet_tpu/models/csr.py).

CDLNetCSR (reference model/net.py:363-463): two filter banks. (A2, B2, t2)
run a plain LISTA on a frame with no neighbour code (the first frame);
(A, B, t) with the gamma bank g run the one-sided CSR prox pulling the code
toward the previous frame's code z_prev. The synthesis dictionary is always
B[0].

CDLNetCSRf2 (model/net.py:464-568): one filter bank and two gamma banks
(g1, g2); the prox is ST with no neighbour code, prox_csr toward z_prev
(g1) or toward z_after (g2) with one, prox_csr_f2 with both.

On backend "pallas"/"cuda" the K-iteration loop runs on the 2D kernels
(kernels/lista2d.py::lista2d_fused with the CSR prox in the analysis
epilogue), on "xla" the plain PyTorch loop. One kernel set serves every
frame size, so the JAX package's choice between its whole-frame and banded
kernels has no counterpart. With gradients enabled the kernel backends
train, as the JAX package's train=True does: the forward goes through
kernels/autodiff.py::csr_fused_2d_train, which stores the z, r and u
(prox argument) histories, and its backward runs the reverse kernels with
the prox's adjoint (kernels/lista2d_bwd.py). Gradients reach every bank,
threshold and gamma and the carried neighbour codes, so the frame
recurrence (train/fit_csr.py) backpropagates across frames. The JAX
package's VMEM gate for that path (lista2d_bwd_supported, which sends
native frames to its XLA scan) has no counterpart: the port trains on the
kernels at every frame size.

Parameters, under the JAX package's params names:
  CDLNetCSR:   A, B, A2, B2: (K, M, C, P, P); t, t2, g: (K, 2, M, 1, 1)
  CDLNetCSRf2: A, B: (K, M, C, P, P); t, g1, g2: (K, 2, M, 1, 1)

Video inference runs each model's frame recurrence through its
video_denoise method: csr_video_denoise and csrf2_video_denoise (the
reference's csr_inference_loop and csr_inference_v2, analyzemri.py:87-182),
at one sigma per call, which blind_sigma estimates when none is given.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cdlnet_tpu_torch import nle
from cdlnet_tpu_torch.core.ops import prox_csr, prox_csr_f2, uball_project
from cdlnet_tpu_torch.core.preprocess import post_process
from cdlnet_tpu_torch.kernels.autodiff import csr_fused_2d_train
from cdlnet_tpu_torch.kernels.lista2d import lista2d_fused
from cdlnet_tpu_torch.models.base import check_backend, register
from cdlnet_tpu_torch.models.cdlnet import _prepare, normalizing_scale
from cdlnet_tpu_torch.ops.conv import conv_transpose2d
from cdlnet_tpu_torch.ops.lista import _threshold, lista_2d


class _CSRBase(nn.Module):
    """What the two CSR models share: the config, the primary banks and
    their init and projection, and the plain and kernel loops."""

    def __init__(self, K, M, P, s, C, t0, adaptive, backend):
        super().__init__()
        check_backend(backend)
        self.K, self.M, self.P, self.s, self.C = K, M, P, s, C
        self.t0, self.adaptive, self.backend = t0, adaptive, backend
        self.A = nn.Parameter(torch.zeros(K, M, C, P, P))
        self.B = nn.Parameter(torch.zeros(K, M, C, P, P))
        self.t = nn.Parameter(torch.zeros(K, 2, M, 1, 1))

    @property
    def pad(self) -> int:
        return (self.P - 1) // 2

    def _init_primary(self, generator, init):
        """One random bank W in every A_k and B_k, spectrally normalized by
        the power method when `init`; t = t0."""
        dev = self.A.device
        W = torch.randn(self.M, self.C, self.P, self.P, generator=generator).to(dev)
        if init:
            W = W * normalizing_scale(W, W, self.C, self.s, self.pad, generator, dev)
        self.A.copy_(W.expand_as(self.A))
        self.B.copy_(W.expand_as(self.B))
        self.t.fill_(self.t0)

    @torch.no_grad()
    def project(self):
        """In place: t >= 0 and each filter of the primary banks A, B on the
        l2 unit ball over (kH, kW); the reference projects nothing else
        (model/net.py:418-424)."""
        self.t.clamp_(min=0.0)
        self.A.copy_(uball_project(self.A, axes=(3, 4)))
        self.B.copy_(uball_project(self.B, axes=(3, 4)))
        return self

    def _run(self, y, sigma, mask, A, B, t, prox, codes):
        """Pre-process y (N, C, H, W), run the K-iteration loop with banks A
        and B (the final synthesis through self.B[0]) and post-process.
        prox(u, k, c) is the plain loop's prox (None: ST at t); `codes` the
        kernels' CSR keywords (lista2d_fused's g, z_prev, g2, z_after).
        On the kernels with gradients enabled it runs the training path,
        csr_fused_2d_train. Returns (xhat, z)."""
        yp, prm, mask, c = _prepare(self, y, sigma, mask)
        if self.backend in ("pallas", "cuda"):
            # the loop's B_0 is never read: the final synthesis is the
            # primary B[0] (model/net.py:460), which takes its gradient
            Bk = torch.cat([self.B[:1], B[1:]]) if B is not self.B else B
            if torch.is_grad_enabled():
                xphat, z = csr_fused_2d_train(yp, A, Bk, t, c, mask=mask,
                                              stride=self.s, **codes)
            else:
                xphat, z = lista2d_fused(yp, A, Bk, t, c, stride=self.s, mask=mask,
                                         return_z=True, **codes)
        else:
            z = lista_2d(yp, A, B, t, c, mask=mask, stride=self.s, prox=prox)
            xphat = conv_transpose2d(z, self.B[0], stride=self.s, padding=self.pad,
                                     output_padding=self.s - 1)
        return post_process(xphat, prm), z


@register("CDLNet_CSR")
class CDLNetCSR(_CSRBase):
    def __init__(self, K: int = 3, M: int = 64, P: int = 7, s: int = 1, C: int = 1,
                 t0: float = 0.0, adaptive: bool = False, backend: str = "xla"):
        super().__init__(K, M, P, s, C, t0, adaptive, backend)
        self.A2 = nn.Parameter(torch.zeros(K, M, C, P, P))
        self.B2 = nn.Parameter(torch.zeros(K, M, C, P, P))
        self.t2 = nn.Parameter(torch.zeros(K, 2, M, 1, 1))
        self.g = nn.Parameter(torch.zeros(K, 2, M, 1, 1))

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None, init: bool = True):
        """Fill the parameters: the primary banks as CDLNet's init; A2 and
        B2 uniform in +-1/sqrt(C P^2), torch's default conv init, which the
        reference leaves them at (model/net.py:381-391: they are not
        normalized); t = t2 = g = t0. Random numbers come from `generator`
        on the CPU. Returns self."""
        self._init_primary(generator, init)
        bound = 1.0 / math.sqrt(self.C * self.P * self.P)
        for p in (self.A2, self.B2):
            u = torch.rand(p.shape, generator=generator)
            p.copy_((2 * u - 1) * bound)
        for p in (self.t2, self.g):
            p.fill_(self.t0)
        return self

    def forward(self, y, z_prev=None, sigma=None, mask=None):
        """Denoise one frame batch y (N, C, H, W), carrying the previous
        frame's code z_prev (N, M, H/s, W/s) or none. Returns (xhat, z)."""
        if z_prev is None:  # the first frame: plain ST on the second bank
            return self._run(y, sigma, mask, self.A2, self.B2, self.t2, None, {})
        return self._run(
            y, sigma, mask, self.A, self.B, self.t,
            lambda u, k, c: prox_csr(u, z_prev, _threshold(self.t[k], c), _threshold(self.g[k], c)),
            dict(g=self.g, z_prev=z_prev))

    def video_denoise(self, noisy, sigma=None, mask=None):
        """A clip (B, C, D, H, W) through the frame recurrence,
        csr_video_denoise. Returns (denoised, the last frame's code)."""
        return csr_video_denoise(self, noisy, sigma, mask)


@register("CDLNet_CSRf2")
class CDLNetCSRf2(_CSRBase):
    def __init__(self, K: int = 3, M: int = 64, P: int = 7, s: int = 1, C: int = 1,
                 t0: float = 0.0, adaptive: bool = False, backend: str = "xla"):
        super().__init__(K, M, P, s, C, t0, adaptive, backend)
        self.g1 = nn.Parameter(torch.zeros(K, 2, M, 1, 1))
        self.g2 = nn.Parameter(torch.zeros(K, 2, M, 1, 1))

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None, init: bool = True):
        """Fill the parameters as CDLNet's init does, with g1 = g2 = t0.
        Returns self."""
        self._init_primary(generator, init)
        self.g1.fill_(self.t0)
        self.g2.fill_(self.t0)
        return self

    def forward(self, y, z_prev=None, z_after=None, sigma=None, mask=None):
        """Denoise one frame batch y (N, C, H, W) with the previous and/or
        following frames' codes (N, M, H/s, W/s), either or both None: the
        prox is chosen per call, as the reference chooses it per iteration
        (model/net.py:544-564). Returns (xhat, z)."""
        t, g1, g2 = self.t, self.g1, self.g2

        def prox(u, k, c):
            tau = _threshold(t[k], c)
            if z_prev is not None and z_after is not None:
                return prox_csr_f2(u, z_prev, z_after, tau, _threshold(g1[k], c), _threshold(g2[k], c))
            if z_prev is not None:
                return prox_csr(u, z_prev, tau, _threshold(g1[k], c))
            return prox_csr(u, z_after, tau, _threshold(g2[k], c))

        codes = {}
        if z_prev is not None:
            codes.update(g=g1, z_prev=z_prev)
        if z_after is not None:
            codes.update(g2=g2, z_after=z_after)
        return self._run(y, sigma, mask, self.A, self.B, t, prox if codes else None, codes)

    def video_denoise(self, noisy, sigma=None, mask=None):
        """A clip (B, C, D, H, W) through the two-pass recurrence,
        csrf2_video_denoise. Returns (denoised, codes)."""
        return csrf2_video_denoise(self, noisy, sigma, mask)


def blind_sigma(noisy, method="MAD"):
    """The one sigma a CSR recurrence runs a call at when none is given:
    255 * the mean of the framewise noise-level estimates over every frame
    of every clip of noisy (B, C, D, H, W), as the JAX package takes it."""
    B, C, D, H, W = noisy.shape
    return 255.0 * nle.noise_level(noisy.transpose(1, 2).reshape(B * D, C, H, W),
                                   method=method).mean()


def _frames(noisy):
    """(B, C, D, H, W) -> the D frames (B, C, H, W)."""
    return noisy.unbind(2)


def csr_video_denoise(model: CDLNetCSR, noisy, sigma=None, mask=None):
    """Frame-recurrent denoising of a noisy clip (B, C, D, H, W), D >= 2.

    The reference's csr_inference_loop (analyzemri.py:87-156): a warm-up on
    frames 0 and 1 — f0 with no code, f1 carrying z0, f0 again carrying z1
    (its output is the frame-0 result) — then the forward recurrence over
    frames 1..D-1 carrying the previous frame's code. One noisy realization
    per frame, as the JAX package does. sigma: None, a scalar or one per
    clip; mask: one (B, C, H, W) mask for every frame. Returns (denoised
    (B, C, D, H, W), the last frame's code)."""
    frames = _frames(noisy)
    _, z0 = model(frames[0], None, sigma, mask=mask)
    _, z1 = model(frames[1], z0, sigma, mask=mask)
    x0, z = model(frames[0], z1, sigma, mask=mask)
    xs = [x0]
    for y_t in frames[1:]:
        xhat, z = model(y_t, z, sigma, mask=mask)
        xs.append(xhat)
    return torch.stack(xs, dim=2), z


def csrf2_video_denoise(model: CDLNetCSRf2, noisy, sigma=None, mask=None):
    """Two-pass denoising of a clip (B, C, D, H, W) with context on both
    sides.

    The reference's csr_inference_v2 (analyzemri.py:161-182): a forward
    sweep collects every frame's code, then frame t >= 1 is denoised again
    with (z[t-1], z[t]) as (z_prev, z_after) — as committed, the second
    pass hands the frame its own first-pass code as z_after — and frame 0
    with z[0] as z_after alone. Pass 2 is one batched forward over the D-1
    frames (the JAX package vmaps it). Returns (denoised (B, C, D, H, W),
    the codes (D, B, M, H/s, W/s))."""
    frames = _frames(noisy)
    B, _, D = noisy.shape[:3]
    _, z = model(frames[0], None, None, sigma, mask=mask)
    zs = [z]
    for y_t in frames[1:]:
        _, z = model(y_t, z, None, sigma, mask=mask)
        zs.append(z)
    z_all = torch.stack(zs)
    x0, _ = model(frames[0], None, z_all[0], sigma, mask=mask)
    if D == 1:
        return x0[:, :, None], z_all
    # frame-major batch: item t * B + b is frame t + 1 of clip b
    C, H, W = noisy.shape[1], noisy.shape[3], noisy.shape[4]
    ys = noisy[:, :, 1:].permute(2, 0, 1, 3, 4).reshape(-1, C, H, W)
    sig = sigma
    if sigma is not None and not isinstance(sigma, (int, float)) \
            and torch.as_tensor(sigma).numel() > 1:  # one per clip
        sig = torch.as_tensor(sigma).reshape(-1).repeat(D - 1)
    m = None if mask is None else mask.repeat(D - 1, 1, 1, 1)
    xs, _ = model(ys, z_all[:-1].reshape(-1, *z.shape[1:]),
                  z_all[1:].reshape(-1, *z.shape[1:]), sig, mask=m)
    xs = xs.reshape(D - 1, B, *xs.shape[1:]).permute(1, 2, 0, 3, 4)
    return torch.cat([x0[:, :, None], xs], dim=2), z_all
