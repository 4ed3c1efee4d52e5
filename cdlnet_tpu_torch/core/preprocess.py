"""Mean subtraction + stride-divisibility reflect padding, and its inverse
(counterpart of cdlnet_tpu/core/preprocess.py).

The mask-aware mean uses sum(x)/sum(mask) when a mask is given, otherwise
the plain mean. `params` is a (mean, pad) tuple consumed by post_process /
post_process_3d. The JAX package's optimization_barrier (a TPU miscompile
defence) has no counterpart here.
"""

from __future__ import annotations

import torch

from cdlnet_tpu_torch.core.pad import (
    calc_pad_2d,
    calc_pad_3d,
    pad_reflect_2d,
    pad_reflect_3d,
    unpad,
    unpad_3d,
)


def _center(x: torch.Tensor, mask):
    """(x - mean) [masked], and the mean, over every dim but the batch."""
    dims = tuple(range(1, x.ndim))
    if mask is not None:
        xmean = x.sum(dim=dims, keepdim=True) / mask.sum(dim=dims, keepdim=True)
        return mask * (x - xmean), xmean
    xmean = x.mean(dim=dims, keepdim=True)
    return x - xmean, xmean


def pre_process(x: torch.Tensor, stride: int, mask=None):
    """2D preprocessing of an (N, C, H, W) batch.

    Returns (x_padded, (mean, pad), mask_padded); mask=None means no mask.
    """
    x, xmean = _center(x, mask)
    pad = calc_pad_2d(x.shape[2], x.shape[3], stride)
    x = pad_reflect_2d(x, pad)
    if mask is not None:
        mask = pad_reflect_2d(mask, pad)
    return x, (xmean, pad), mask


def post_process(x: torch.Tensor, params) -> torch.Tensor:
    """Invert pre_process: unpad, then re-add the mean."""
    xmean, pad = params
    return unpad(x, pad) + xmean


def pre_process_3d(x: torch.Tensor, stride: int, mask=None):
    """3D preprocessing of an (N, C, D, H, W) batch.

    Returns (x_padded, (mean, pad), mask_padded); mask=None means no mask.
    """
    x, xmean = _center(x, mask)
    pad = calc_pad_3d(x.shape[2], x.shape[3], x.shape[4], stride)
    x = pad_reflect_3d(x, pad)
    if mask is not None:
        mask = pad_reflect_3d(mask, pad)
    return x, (xmean, pad), mask


def post_process_3d(x: torch.Tensor, params) -> torch.Tensor:
    """Invert pre_process_3d: unpad, then re-add the mean."""
    xmean, pad = params
    return unpad_3d(x, pad) + xmean
