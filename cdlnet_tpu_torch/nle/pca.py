"""PCA blind noise-level estimator, weak-textured patches (counterpart of
cdlnet_tpu/nle/pca.py; Chen et al.).

Reference: model/nle.py:29-110. sigma^2 is the smallest eigenvalue of the
(non-centered) covariance of the image's p x p patches; each further
iteration keeps only the patches whose gradient energy lies below
tau = sigma^2 * tau0, tau0 a gamma-distribution quantile of the derivative
operators' spectrum, and takes the smallest eigenvalue again.

As in the JAX package, the selection is a 0/1 weight vector inside the
covariance product, and "too few patches" keeps the previous estimate.
Here the estimator runs on a batch of images at once: the covariances of
all images (N, p^2, p^2) come from one batched product, and one batched
eigvalsh per iteration serves the whole batch (on CUDA each eigvalsh waits
for the device to check its result, so a 16-frame clip costs itr - 1 such
waits, not 16 times that). The patch matrices take p^2 floats per position
of every image, so images are taken CHUNK_BYTES of patch matrix at a time;
the estimate is per image, so the chunking does not change it. Products
are fp32 (TF32 off, the chip_smoke and test setting), summed in float64
over blocks of positions (_second_moment), and the 49 x 49 eigenvalue
problems are float64; a patch whose gradient energy lies at tau can still
fall on either side of it between two fp32 programs.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

_KH = np.array([[0.5, 0.0, -0.5]], dtype=np.float64)  # horizontal derivative
# bytes of patch matrix (p^2 floats a position) one chunk of images may take
CHUNK_BYTES = 2 << 30
# patch positions whose fp32 products are summed in fp32 before the float64
# sum over blocks
BLOCK = 256


def _convmtx2(H: np.ndarray, m: int, n: int) -> np.ndarray:
    """2D convolution matrix T s.t. T @ vec(patch) = vec(valid conv)."""
    s = H.shape
    T = np.zeros(((m - s[0] + 1) * (n - s[1] + 1), m * n))
    k = 0
    for i in range(m - s[0] + 1):
        for j in range(n - s[1] + 1):
            for p in range(s[0]):
                row = (i + p) * n + j
                T[k, row : row + s[1]] = H[p]
            k += 1
    return T


@lru_cache(maxsize=None)
def _tau0(patchsize: int, conf: float) -> float:
    """Gamma-quantile threshold scale from the derivative operators' spectrum
    (host numpy and scipy, once per (patchsize, conf))."""
    from scipy.stats import gamma

    Dh = _convmtx2(_KH, patchsize, patchsize)
    Dv = _convmtx2(_KH.T, patchsize, patchsize)
    DD = Dh.T @ Dh + Dv.T @ Dv
    r = np.linalg.matrix_rank(DD)
    Dtr = np.trace(DD)
    return float(gamma.ppf(conf, r / 2.0, scale=2.0 * Dtr / r))


def _im2col(x: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """(N, H, W) -> (N, m*n, (H-m+1)*(W-n+1)) patch columns, rows in
    (i, j) order and positions row-major (model/nle.py:91-94)."""
    return F.unfold(x[:, None], (m, n))


def _box_sum(x: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """(N, H, W) -> (N, (H-m+1)*(W-n+1)): the sum of every m x n window,
    the column sums of _im2col(x, m, n) without the patch matrix."""
    ones = torch.ones(1, 1, m, n, dtype=x.dtype, device=x.device)
    return F.conv2d(x[:, None], ones).flatten(1)


def _second_moment(X: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """sum_i w_i x_i x_i^T over the patch columns x_i of X (N, nb, p^2,
    BLOCK), w (N, nb, BLOCK) of 0/1 or None for all ones: (N, p^2, p^2)
    float64. The products are fp32, summed in fp32 over each block of
    BLOCK positions and in float64 over the blocks. sigma^2 is ~1e-4 of the
    covariance's largest eigenvalue (the patches' raw second moment), and
    one fp32 sum over every position of a frame (~1e4 to ~4e5 positive
    terms) lost ~1e-3 of sigma at sigma 10 on a 128^2 image on an H100
    (cuBLAS), ~2e-4 on the CPU; summed by blocks, ~1e-5 on the CPU."""
    Y = X if w is None else X * w[:, :, None, :]
    return (Y @ X.mT).sum(dim=1, dtype=torch.float64)


def _min_eig(cov: torch.Tensor) -> torch.Tensor:
    """The smallest eigenvalue of each float64 (p^2, p^2) matrix."""
    return torch.linalg.eigvalsh(cov)[:, 0]


def _pca_images(x: torch.Tensor, patchsize: int, tau0: float, itr: int):
    """x: (N, H, W), one channel of N images. Returns (sig2, tau, num),
    each (N,)."""
    p = patchsize
    kh = torch.as_tensor(_KH, dtype=x.dtype, device=x.device)
    xh = F.conv2d(x[:, None], kh[None, None])[:, 0] ** 2
    xv = F.conv2d(x[:, None], kh.T[None, None])[:, 0] ** 2
    X = _im2col(x, p, p)                                # (N, p*p, Np)
    Xtr = _box_sum(xh, p, p - 2) + _box_sum(xv, p - 2, p)  # (N, Np) gradient energy
    N, P2, Np = X.shape
    # blocks of BLOCK positions, zero-padded: a pad column adds nothing to a
    # moment, and its infinite gradient energy is never selected
    nb = -(-Np // BLOCK)
    X = F.pad(X, (0, nb * BLOCK - Np)).view(N, P2, nb, BLOCK).transpose(1, 2).contiguous()
    Xtr = F.pad(Xtr, (0, nb * BLOCK - Np), value=float("inf")).view(N, nb, BLOCK)

    if Np < p * p:
        sig2 = x.new_zeros(N)
    else:
        sig2 = _min_eig(_second_moment(X) / (Np - 1)).to(x.dtype)
    tau = x.new_full((N,), float("inf"))
    w = (Xtr < tau[:, None, None]).to(x.dtype)
    for _ in range(2, itr):
        tau = sig2 * tau0
        w = w * (Xtr < tau[:, None, None]).to(x.dtype)
        count = w.sum(dim=(1, 2))
        cov = _second_moment(X, w) / torch.clamp(count - 1.0, min=1.0).double()[:, None, None]
        sig2 = torch.where(count >= p * p, _min_eig(cov).to(x.dtype), sig2)
    return sig2, tau, w.sum(dim=(1, 2))


def nle_pca(img: torch.Tensor, patchsize: int = 7, conf: float = 1 - 1e-6, itr: int = 3):
    """img: (N, C, H, W). Returns (sigma_hat, tau, num), each (N, C): one
    estimate per image and channel, on img's device. (The JAX package's
    nle_pca estimates img[0] alone and returns scalars at C = 1, (C,)
    arrays otherwise; row n here is its result on img[n:n+1].)"""
    tau0 = _tau0(patchsize, conf)
    N, C, H, W = img.shape
    x = img.reshape(N * C, H, W)
    per_image = max(1, (H - patchsize + 1) * (W - patchsize + 1) * patchsize**2
                    * x.element_size())
    step = max(1, CHUNK_BYTES // per_image)
    outs = [_pca_images(x[i : i + step], patchsize, tau0, itr)
            for i in range(0, N * C, step)]
    sig2, tau, num = (torch.cat(o).reshape(N, C) for o in zip(*outs))
    return torch.sqrt(torch.clamp(sig2, min=0.0)), tau, num
