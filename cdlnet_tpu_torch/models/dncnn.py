"""DnCNN and FFDNet baseline denoisers (counterpart of
cdlnet_tpu/models/dncnn.py).

DnCNN (reference model/net.py:689-713): a first conv + ReLU (with bias),
K-2 x [conv (no bias) + BatchNorm + ReLU], a last conv (with bias); it
predicts the noise n and returns (y - n, n).

FFDNet (model/net.py:715-730): the DnCNN backbone over the x2
pixel-unshuffled input (reflect-padded to even size) with a constant
noise-level map sigma/255 as one more channel, pixel-shuffled back and
unpadded; returns (xhat, noise_map). The map is broadcast to the batch,
one level per image when sigma is one per image (the reference builds it
with batch dim 1, which breaks torch.cat for N > 1; the JAX package
broadcasts too).

Parameters keep the JAX package's names and layouts (torch conv layout):
  w_in (M, Ci, P, P), b_in (M,), w_mid (K-2, M, M, P, P),
  bn_scale, bn_bias (K-2, M), w_out (Co, M, P, P), b_out (Co,)
and the BatchNorm running statistics are buffers bn_mean, bn_var (K-2, M),
the JAX package's `state`. BatchNorm follows torch (momentum 0.1, eps
1e-5): in train() mode it normalizes by the batch statistics and updates
the running ones in place (the variance unbiased), in eval() mode it
normalizes by the running statistics. The convolutions run on F.conv2d
(cuDNN on the card): the JAX package has no Pallas kernel for these
families.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cdlnet_tpu_torch.core.pad import calc_pad_2d, pad_reflect_2d, unpad
from cdlnet_tpu_torch.models.base import register

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def batch_norm_global(h, running_mean, running_var, weight, bias, group):
    """F.batch_norm in training mode with the moments of the whole batch
    that the ranks of `group` share (data parallelism: the JAX package's
    GSPMD computes them over the global batch): the per-channel sums and
    centred squares are all-reduced, their cotangents too. The running
    statistics update in place, alike on every rank. Every rank holds as
    many rows (fit requires the batch to divide over the data axis), so
    the count needs no collective."""
    from cdlnet_tpu_torch.dist.comm import group_size, reduce

    dims = (0, 2, 3)
    count = (h.numel() // h.shape[1]) * group_size(group)
    mean = reduce(h.sum(dims), group, bwd_sum=True) / count
    xc = h - mean[None, :, None, None]
    var = reduce((xc * xc).sum(dims), group, bwd_sum=True) / count
    with torch.no_grad():
        running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
        running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var * (count / (count - 1)))
    scale = weight / torch.sqrt(var + BN_EPS)
    return xc * scale[None, :, None, None] + bias[None, :, None, None]


@register("DnCNN")
class DnCNN(nn.Module):
    # forward() ignores sigma: the eval CLIs pass none, as in the JAX package
    adaptive = False
    # the ProcessGroup whose ranks share a data-parallel batch: train()
    # mode's BatchNorm then takes the moments of the whole batch
    # (batch_norm_global); None on one rank
    bn_group = None

    def __init__(self, Co: int = 1, Ci: int = 1, K: int = 17, M: int = 64, P: int = 3):
        super().__init__()
        self.Co, self.Ci, self.K, self.M, self.P = Co, Ci, K, M, P
        nmid = K - 2
        self.w_in = nn.Parameter(torch.zeros(M, Ci, P, P))
        self.b_in = nn.Parameter(torch.zeros(M))
        self.w_mid = nn.Parameter(torch.zeros(nmid, M, M, P, P))
        self.bn_scale = nn.Parameter(torch.ones(nmid, M))
        self.bn_bias = nn.Parameter(torch.zeros(nmid, M))
        self.w_out = nn.Parameter(torch.zeros(Co, M, P, P))
        self.b_out = nn.Parameter(torch.zeros(Co))
        self.register_buffer("bn_mean", torch.zeros(nmid, M))
        self.register_buffer("bn_var", torch.ones(nmid, M))

    @property
    def pad(self) -> int:
        return (self.P - 1) // 2

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None, init: bool = True):
        """Fill the parameters as the JAX package's init does: the conv
        weights uniform in +-1/sqrt(fan_in), the biases 0, the BatchNorm
        scale 1 and shift 0, and fresh running statistics (mean 0,
        variance 1). Random numbers come from `generator` on the CPU, so a
        seed gives the same weights on every device. `init` (the LISTA
        families' power method) has nothing to do here. Returns self."""
        def uniform(p, fan_in):
            b = 1.0 / fan_in ** 0.5
            p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * b)

        P2 = self.P * self.P
        uniform(self.w_in, self.Ci * P2)
        uniform(self.w_mid, self.M * P2)
        uniform(self.w_out, self.M * P2)
        for p in (self.b_in, self.bn_bias, self.b_out, self.bn_mean):
            p.zero_()
        for p in (self.bn_scale, self.bn_var):
            p.fill_(1.0)
        return self

    def project(self):
        """No constraint set: a no-op, as in the JAX package."""
        return self

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        """The conv stack on (N, Ci, H, W) -> (N, Co, H, W)."""
        h = F.relu(F.conv2d(x, self.w_in, self.b_in, padding=self.pad))
        for i in range(self.K - 2):
            h = F.conv2d(h, self.w_mid[i], padding=self.pad)
            # the per-layer rows of the stacked buffers: batch_norm's
            # in-place update of the running stats lands in bn_mean/bn_var
            if self.training and self.bn_group is not None:
                h = batch_norm_global(h, self.bn_mean[i], self.bn_var[i], self.bn_scale[i],
                                      self.bn_bias[i], self.bn_group)
            else:
                h = F.batch_norm(h, self.bn_mean[i], self.bn_var[i], self.bn_scale[i],
                                 self.bn_bias[i], training=self.training,
                                 momentum=BN_MOMENTUM, eps=BN_EPS)
            h = F.relu(h)
        return F.conv2d(h, self.w_out, self.b_out, padding=self.pad)

    def forward(self, y, sigma=None, mask=None, return_z=False):
        """Denoise (N, C, H, W) y. Returns (y - n, n), n the predicted
        noise. sigma, mask and return_z are accepted for the other
        families' signature and unused (the reference's forward(*args))."""
        n = self.backbone(y)
        return y - n, n


@register("FFDNet")
class FFDNet(DnCNN):
    # forward() takes sigma for its noise map: the eval CLIs and a blind
    # Denoiser pass the known or estimated level (see ROADMAP.md queue 3)
    adaptive = True

    def __init__(self, C: int = 1, K: int = 17, M: int = 64, P: int = 3):
        super().__init__(Co=4 * C, Ci=4 * C + 1, K=K, M=M, P=P)
        self.C = C

    def forward(self, y, sigma=None, mask=None, return_z=False):
        """Denoise (N, C, H, W) y at noise level sigma (a scalar or one per
        image on [0, 255]; None is 0). Returns (xhat, noise_map), the map
        (N, 1, H'/2, W'/2) at the padded input's half size."""
        if sigma is None:
            sigma = 0.0
        pad = calc_pad_2d(y.shape[2], y.shape[3], 2)
        yp = pad_reflect_2d(y, pad)
        z = F.pixel_unshuffle(yp, 2)
        sig = torch.as_tensor(sigma, dtype=y.dtype, device=y.device) / 255.0
        sig = sig.reshape(-1, 1, 1, 1)
        noise_map = sig.expand(z.shape[0], 1, z.shape[2], z.shape[3])
        out = self.backbone(torch.cat([z, noise_map], dim=1))
        return unpad(F.pixel_shuffle(out, 2), pad), noise_map
