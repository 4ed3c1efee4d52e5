"""Mean subtraction + stride-divisibility reflect padding, and its inverse
(counterpart of cdlnet_tpu/core/preprocess.py, 3D half).

The mask-aware mean uses sum(x)/sum(mask) when a mask is given, otherwise
the plain mean. `params` is a (mean, pad) tuple consumed by post_process_3d.
"""

from __future__ import annotations

import torch

from cdlnet_tpu_torch.core.pad import calc_pad_3d, pad_reflect_3d, unpad_3d


def pre_process_3d(x: torch.Tensor, stride: int, mask=None):
    """3D preprocessing of an (N, C, D, H, W) batch.

    Returns (x_padded, (mean, pad), mask_padded); mask=None means no mask.
    """
    if mask is not None:
        xmean = x.sum(dim=(1, 2, 3, 4), keepdim=True) / mask.sum(
            dim=(1, 2, 3, 4), keepdim=True
        )
        x = mask * (x - xmean)
    else:
        xmean = x.mean(dim=(1, 2, 3, 4), keepdim=True)
        x = x - xmean
    pad = calc_pad_3d(x.shape[2], x.shape[3], x.shape[4], stride)
    x = pad_reflect_3d(x, pad)
    if mask is not None:
        mask = pad_reflect_3d(mask, pad)
    return x, (xmean, pad), mask


def post_process_3d(x: torch.Tensor, params) -> torch.Tensor:
    """Invert pre_process_3d: unpad, then re-add the mean."""
    xmean, pad = params
    return unpad_3d(x, pad) + xmean
