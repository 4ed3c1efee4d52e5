"""Training losses and metrics (counterpart of cdlnet_tpu/train/losses.py):
MSE, MC-SURE (unsupervised), SSIM and the combined VGG16 loss.

MC-SURE (reference train.py:87-93): Stein's unbiased risk estimate with a
Monte-Carlo divergence term from a second forward pass on a perturbed input:
  mean((y - f(y))^2) + (2/h) * mean((sigma/255)^2 * b * (f(y + h b) - f(y)))

Combined loss (reference loss.py:6-57): alpha*MSE + beta*VGG16-relu3_3
feature MSE (per frame, grayscale repeated to 3 channels) + gamma*(1-SSIM).
The VGG16 weights load from a torchvision checkpoint file when one exists
at _VGG_WEIGHT_PATHS (nothing is downloaded); without weights the
perceptual term is skipped with a warning, once per process. The VGG
convolutions run on F.conv2d (cuDNN on the card): the JAX package computes
them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math
import os
import warnings
from functools import lru_cache

import torch
import torch.nn.functional as F

# the gaussian window of ssim: its size and standard deviation
SSIM_WIN = 11
SSIM_WIN_SIGMA = 1.5


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr_from_mse(mse: float) -> float:
    return -10.0 * math.log10(max(float(mse), 1e-30))


def mcsure_loss(apply_fn, obsrv, sigma, *, b=None, generator=None, h: float = 1e-3):
    """Unsupervised MC-SURE of apply_fn(y) -> xhat at the observation obsrv.
    apply_fn runs twice, first on obsrv, then on obsrv + h b. sigma: a
    scalar or per-sample tensor on the [0, 255] scale that broadcasts
    against obsrv. b: the probe, standard normal of obsrv's shape, drawn
    from `generator` (on obsrv's device) when not given."""
    xhat = apply_fn(obsrv)
    if b is None:
        b = torch.randn(obsrv.shape, generator=generator, device=obsrv.device,
                        dtype=obsrv.dtype)
    xhat_b = apply_fn(obsrv + h * b)
    sig = torch.as_tensor(sigma, dtype=obsrv.dtype, device=obsrv.device) / 255.0
    div = 2.0 * torch.mean(sig**2 * b * (xhat_b - xhat)) / h
    return torch.mean((obsrv - xhat) ** 2) + div


def _gaussian_window(like):
    x = torch.arange(SSIM_WIN, dtype=like.dtype, device=like.device) - (SSIM_WIN - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * SSIM_WIN_SIGMA**2))
    g = g / g.sum()
    return torch.outer(g, g)


def _ssim_map(x, y, data_range):
    """The SSIM map of (N, C, H, W) x and y over the valid window
    positions; data_range a scalar or a tensor that broadcasts against the
    map (one range per image: (N, 1, 1, 1))."""
    C = x.shape[1]
    win = _gaussian_window(x)
    w = win[None, None].expand(C, 1, SSIM_WIN, SSIM_WIN)

    def filt(v):
        return F.conv2d(v, w, groups=C)

    C1, C2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mu_x, mu_y = filt(x), filt(y)
    mu_x2, mu_y2, mu_xy = mu_x**2, mu_y**2, mu_x * mu_y
    # clamp residual negative variances from fp32 rounding
    sig_x = torch.clamp(filt(x * x) - mu_x2, min=0.0)
    sig_y = torch.clamp(filt(y * y) - mu_y2, min=0.0)
    sig_xy = filt(x * y) - mu_xy
    cs = (2 * sig_xy + C2) / (sig_x + sig_y + C2)
    return ((2 * mu_xy + C1) / (mu_x2 + mu_y2 + C1)) * cs


def ssim(x, y, data_range=1.0):
    """Mean SSIM over an (N, C, H, W) batch: an 11x11 gaussian window of
    sigma 1.5 per channel, valid positions only, K1 = 0.01, K2 = 0.03 (the
    defaults of pytorch_msssim, which the reference's loss used)."""
    return torch.mean(_ssim_map(x, y, data_range))


# ---------------------------------------------------------------------------
# VGG16 feature extractor (torchvision's vgg16().features[:16], through
# relu3_3), on weights read from a local torchvision checkpoint
# ---------------------------------------------------------------------------

_VGG16_LAYERS = [  # (out_ch, torchvision features index) for convs up to 15
    (64, 0), (64, 2), ("pool", None), (128, 5), (128, 7), ("pool", None),
    (256, 10), (256, 12), (256, 14),
]

# torch hub's checkpoint cache of the current user and of root, where
# torchvision stores vgg16's weights
_VGG_WEIGHT_PATHS = [
    os.path.expanduser("~/.cache/torch/hub/checkpoints/vgg16-397923af.pth"),
    os.path.expanduser("~root/.cache/torch/hub/checkpoints/vgg16-397923af.pth"),
]


@lru_cache(maxsize=1)
def _load_vgg16_weights():
    """[(weight, bias)] of the seven convs through relu3_3, CPU tensors, from
    the first of _VGG_WEIGHT_PATHS that exists (read weights-only), or None
    when none does. Cached: call _load_vgg16_weights.cache_clear() after
    the files change."""
    for p in _VGG_WEIGHT_PATHS:
        if os.path.exists(p):
            sd = torch.load(p, map_location="cpu", weights_only=True)
            return [(sd[f"features.{i}.weight"].float(), sd[f"features.{i}.bias"].float())
                    for _, i in _VGG16_LAYERS if i is not None]
    return None


def vgg16_features(x):
    """x: (N, 3, H, W) in [0,1]. Returns the relu3_3 features, or None when
    no pretrained weights are on disk."""
    weights = _load_vgg16_weights()
    if weights is None:
        return None
    h = x
    wi = 0
    for spec, _ in _VGG16_LAYERS:
        if spec == "pool":
            h = F.max_pool2d(h, 2)
        else:
            w, b = weights[wi]
            wi += 1
            h = F.relu(F.conv2d(h, w.to(x), b.to(x), padding=1))
    return h


_warned_no_vgg = False


def combined_loss(output, target, alpha=1.0, beta=0.01, gamma=0.1):
    """alpha*MSE + beta*VGG-feature MSE + gamma*(1-SSIM) over (N, C, D, H, W)
    video batches, computed per frame (reference loss.py:17-57).

    The perceptual term batches all frames through one VGG forward: for
    equal-sized frames the batched feature MSE equals the reference's mean
    of per-frame MSEs (loss.py:20-37). The SSIM term follows the
    reference's per-frame data_range = output_frame.max() - .min()
    (loss.py:52; the max and min span that frame index's whole (N, 3, H, W)
    slab, as torch's tensor .max() does, clamped at 1e-6), averaging
    1-SSIM over frames."""
    global _warned_no_vgg
    total = alpha * mse_loss(output, target)
    N, C, D, H, W = output.shape
    # frames to (N*D, C, H, W), grayscale repeated to 3 channels
    of = output.transpose(1, 2).reshape(N * D, C, H, W)
    tf = target.transpose(1, 2).reshape(N * D, C, H, W)
    reps = 3 if C == 1 else 1
    of3 = of.repeat_interleave(reps, dim=1)
    tf3 = tf.repeat_interleave(reps, dim=1)

    feats_o = vgg16_features(of3)
    if feats_o is not None:
        feats_t = vgg16_features(tf3)
        total = total + beta * mse_loss(feats_o, feats_t)
    elif not _warned_no_vgg:
        warnings.warn(
            "VGG16 pretrained weights not found on disk; combined loss runs "
            "without the perceptual term (alpha*MSE + gamma*(1-SSIM)).")
        _warned_no_vgg = True

    # per-frame SSIM with per-frame data_range (loss.py:39-55): every frame
    # has as many map positions, so the mean over frames of their mean SSIM
    # is the mean of the batched map
    slabs = of3.reshape(N, D, -1)
    dr = torch.clamp(slabs.amax(dim=(0, 2)) - slabs.amin(dim=(0, 2)), min=1e-6)
    dr = dr.expand(N, D).reshape(N * D, 1, 1, 1)
    return total + gamma * (1.0 - torch.mean(_ssim_map(of3, tf3, dr)))
