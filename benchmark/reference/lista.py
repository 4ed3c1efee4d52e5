"""The LISTA denoisers in plain PyTorch (F.conv2d / F.conv3d), float32.

    z_0   = ST(A_0 y, tau_0)
    z_k   = ST(z_{k-1} - A_k (B_k z_{k-1} - y), tau_k),   k = 1..K-1
    xhat  = B_0 z_{K-1}
    tau_k = t[k, 0] + (sigma / 255) t[k, 1]          (adaptive models)

y is the input less its mean (over every axis but the batch), reflect-
padded so that each spatial size divides the stride s; the output is
unpadded and the mean added back. A_k are strided convolutions (padding
P // 2 per axis), B_k their transposes (output padding s - 1), so each B_k
is the exact adjoint of A_k.

The Denoiser pads H and W of an input up to multiples of its bucket by
reflection at the bottom and right, runs the model on the padded input,
and crops the output back; blind, sigma is 255 times the MAD estimate of
the padded input (mad.py).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_fp32(on: bool = True):
    """TF32 off for cuDNN and matmuls within the block (on=False: on), as
    they were after."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = not on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest), as a tensor core
    rounds the operands of a TF32 product; gradients pass straight through.
    cuDNN keeps some float32 convolutions off the tensor cores whatever
    allow_tf32 says (those with one input channel among them), so the
    control rounds the operands of every convolution itself."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


def soft_threshold(x, tau):
    return torch.sign(x) * torch.clamp(x.abs() - tau, min=0.0)


def _pad_1d(n: int, s: int) -> tuple[int, int]:
    extra = -(-n // s) * s - n
    return extra // 2, extra - extra // 2


def _convs(ndim: int, P, s: int, tf32: bool = False):
    """(analysis, synthesis) of one bank for 2D (ndim 4) or 3D (ndim 5);
    with tf32 their operands rounded to TF32."""
    pad = tuple(p // 2 for p in P)
    r = to_tf32 if tf32 else (lambda x: x)
    conv, convt = (F.conv2d, F.conv_transpose2d) if ndim == 4 else (F.conv3d, F.conv_transpose3d)
    return (lambda x, w: conv(r(x), r(w), stride=s, padding=pad),
            lambda z, w: convt(r(z), r(w), stride=s, padding=pad, output_padding=s - 1))


def lista_forward(A, B, t, y, sigma, s: int, adaptive: bool = True, tf32: bool = False):
    """The denoised batch of y (N, C, [D,] H, W) at sigma (a number or (N,)
    on the [0, 255] scale). A, B: (K, M, C, *P); t: (K, 2, M, 1, ...).
    tf32: every convolution's operands rounded to TF32 (the control)."""
    nd = y.ndim
    dims = tuple(range(1, nd))
    mean = y.mean(dim=dims, keepdim=True)
    x = y - mean
    pads = [_pad_1d(n, s) for n in y.shape[2:]]
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if any(flat):
        x = F.pad(x, flat, mode="reflect")
    if adaptive and sigma is not None:
        c = torch.as_tensor(sigma, dtype=y.dtype, device=y.device) / 255.0
        c = c.reshape((-1,) + (1,) * (nd - 1)) if c.ndim else c
    else:
        c = 0.0
    analysis, synthesis = _convs(nd, A.shape[3:], s, tf32)
    z = soft_threshold(analysis(x, A[0]), t[0, 0:1] + c * t[0, 1:2])
    for k in range(1, A.shape[0]):
        r = synthesis(z, B[k]) - x
        z = soft_threshold(z - analysis(r, A[k]), t[k, 0:1] + c * t[k, 1:2])
    out = synthesis(z, B[0])
    sl = [slice(None), slice(None)] + [slice(lo, n + lo) for (lo, _), n in
                                       zip(pads, y.shape[2:])]
    return out[tuple(sl)] + mean


def bucket_pad(y, bucket: int):
    """y (N, C, [D,] H, W) reflect-padded at the bottom and right of H and W
    up to multiples of bucket."""
    H, W = y.shape[-2:]
    ph, pw = -(-H // bucket) * bucket - H, -(-W // bucket) * bucket - W
    if not (ph or pw):
        return y
    if y.ndim == 5:  # F.pad's reflect mode takes 2D padding on 4D input
        N, C, D = y.shape[:3]
        return F.pad(y.reshape(N, C * D, H, W), (0, pw, 0, ph),
                     mode="reflect").reshape(N, C, D, H + ph, W + pw)
    return F.pad(y, (0, pw, 0, ph), mode="reflect")


def power_method_scale(W, s: int, probe):
    """1 / sqrt(L), L the largest eigenvalue of D D^T for the bank W (M, C,
    *P) at stride s, from 200 iterations on `probe` (1, C, *shape)."""
    analysis, synthesis = _convs(W.ndim, W.shape[2:], s)
    x = probe
    for _ in range(200):
        x = synthesis(analysis(x, W), W)
        x = x / torch.sqrt(torch.sum(x * x))
    L = torch.sum(x * synthesis(analysis(x, W), W))
    return 1.0 / torch.sqrt(L)
