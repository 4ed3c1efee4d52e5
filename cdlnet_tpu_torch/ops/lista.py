"""The unrolled LISTA loop in plain PyTorch (counterpart of
cdlnet_tpu/ops/lista.py::lista_2d and lista_3d):

    z0    = ST(A0 y, tau_0)
    z_k   = ST(z - A_k (mask * B_k z - y), tau_k),   k = 1..K-1
    tau_k = t[k,0] + c * t[k,1]          (c = sigma/255 if adaptive else 0)

This is the reference the hand kernels (kernels/lista2d.py,
kernels/lista3d.py) are held to, and the path of backend "xla".
"""

from __future__ import annotations

import torch

from cdlnet_tpu_torch.core.ops import ST
from cdlnet_tpu_torch.ops.conv import (
    conv2d,
    conv3d,
    conv_transpose2d,
    conv_transpose3d,
)


def _threshold(t_k, c):
    """tau_k = t[k, 0:1] + c * t[k, 1:2]; broadcasts (1,M,1,1[,1]) with c."""
    return t_k[0:1] + c * t_k[1:2]


def _st(t):
    """The default prox of the loop: ST at tau_k."""
    return lambda u, k, c: ST(u, _threshold(t[k], c))


def _lista(yp, A, B, t, c, mask, analysis, synthesis, return_codes=False, prox=None):
    prox = prox or _st(t)
    z = prox(analysis(yp, A[0]), 0, c)
    codes = [z] if return_codes else None
    for k in range(1, A.shape[0]):
        Bz = synthesis(z, B[k])
        r = Bz - yp if mask is None else mask * Bz - yp
        z = prox(z - analysis(r, A[k]), k, c)
        if return_codes:
            codes.append(z)
    return (z, torch.stack(codes)) if return_codes else z


def lista_2d(yp, A, B, t, c, mask=None, stride=1, return_codes=False, prox=None):
    """Run the K-iteration 2D LISTA loop; returns the final codes z
    (N, M, H/s, W/s), and with return_codes (z, codes), codes the
    (K, N, M, H/s, W/s) stack of every iteration's z_k.

    yp: (N, C, H, W) pre-processed input; A, B: (K, M, C, P, P); t: (K, 2,
    M, 1, 1); c: scalar or (N, 1, 1, 1); mask: optional (N, C, H, W).
    prox(u, k, c) replaces ST at tau_k (the CSR models' temporal proxes).
    """
    pad = (A.shape[-1] - 1) // 2
    return _lista(
        yp, A, B, t, c, mask,
        lambda x, w: conv2d(x, w, stride=stride, padding=pad),
        lambda z, w: conv_transpose2d(z, w, stride=stride, padding=pad,
                                      output_padding=stride - 1),
        return_codes, prox,
    )


def res_block(z, w1, w2):
    """The per-iteration residual refinement block (model/net.py:146-151):
    relu(conv3d(z, w1)) -> conv3d(., w2) -> relu(. + z), 3x3x3 convs with
    padding 1."""
    out = torch.relu(conv3d(z, w1, stride=1, padding=1))
    return torch.relu(conv3d(out, w2, stride=1, padding=1) + z)


def lista_3d(yp, A, B, t, c, mask=None, stride=1, residual=None, return_codes=False):
    """Run the K-iteration 3D (video) LISTA loop; returns the final codes z
    (N, M, D/s, H/s, W/s), and with return_codes (z, codes), codes the
    (K, N, M, D/s, H/s, W/s) stack of every iteration's z_k.

    yp: (N, C, D, H, W); A, B: (K, M, C, Pd, Ph, Pw); t: (K, 2, M, 1, 1, 1);
    c: scalar or (N, 1, 1, 1, 1); mask: optional (N, C, D, H, W).
    residual: optional mapping with conv1, conv2: (K, M, M, 3, 3, 3), the
    residual blocks applied after every threshold, the first included
    (model/net.py:200-207).
    """
    Pd, Ph, Pw = A.shape[-3:]
    pad = (Pd // 2, Ph // 2, Pw // 2)
    prox = None
    if residual is not None:
        st = _st(t)

        def prox(u, k, c):
            return res_block(st(u, k, c), residual["conv1"][k], residual["conv2"][k])
    return _lista(
        yp, A, B, t, c, mask,
        lambda x, w: conv3d(x, w, stride=stride, padding=pad),
        lambda z, w: conv_transpose3d(z, w, stride=stride, padding=pad,
                                      output_padding=stride - 1),
        return_codes, prox,
    )
