"""Stride-divisibility padding math (counterpart of cdlnet_tpu/core/pad.py).

Pad tuples follow the torch F.pad ordering used by the reference:
  2D: (left, right, top, bottom)             — W first, then H
  3D: (left, right, top, bottom, front, back) — W, H, then D
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def calc_pad_1d(L: int, M: int) -> tuple[int, int]:
    """Pad sizes (lo, hi) so a length-L signal is divisible by M."""
    if L % M == 0:
        return (0, 0)
    Ldiff = math.ceil(L / M) * M - L
    return (Ldiff // 2, Ldiff - Ldiff // 2)


def calc_pad_2d(H: int, W: int, M: int) -> tuple[int, int, int, int]:
    """(left, right, top, bottom) pads so (H, W) divide M."""
    return (*calc_pad_1d(W, M), *calc_pad_1d(H, M))


def calc_pad_3d(D: int, H: int, W: int, M: int) -> tuple[int, int, int, int, int, int]:
    """(left, right, top, bottom, front, back) pads so (D, H, W) divide M."""
    return (*calc_pad_1d(W, M), *calc_pad_1d(H, M), *calc_pad_1d(D, M))


def pad_reflect_2d(x: torch.Tensor, pad: tuple[int, int, int, int]) -> torch.Tensor:
    """Reflect-pad the trailing (H, W) dims of an (N, C, H, W) tensor."""
    if not any(pad):
        return x
    return F.pad(x, pad, mode="reflect")


def pad_reflect_3d(x: torch.Tensor, pad: tuple[int, int, int, int, int, int]) -> torch.Tensor:
    """Reflect-pad the trailing (D, H, W) dims of an (N, C, D, H, W) tensor."""
    if not any(pad):
        return x
    return F.pad(x, pad, mode="reflect")


def unpad(x: torch.Tensor, pad: tuple[int, int, int, int]) -> torch.Tensor:
    """Invert pad_reflect_2d on the trailing (H, W) dims."""
    l, r, t, b = pad
    H, W = x.shape[-2], x.shape[-1]
    return x[..., t : H - b, l : W - r]


def unpad_3d(x: torch.Tensor, pad: tuple[int, int, int, int, int, int]) -> torch.Tensor:
    """Invert pad_reflect_3d on the trailing (D, H, W) dims."""
    l, r, t, b, f, k = pad
    D, H, W = x.shape[-3], x.shape[-2], x.shape[-1]
    return x[..., f : D - k, t : H - b, l : W - r]
