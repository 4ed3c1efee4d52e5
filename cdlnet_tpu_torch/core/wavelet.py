"""The bior4.4 2D wavelet filter bank (counterpart of the part of
cdlnet_tpu/core/wavelet.py that the MAD noise estimator reads).

The 1D bank is pywt's bior4.4 (the CDF 9/7 pair, 10 taps each, zero-padded
as pywt aligns them), inlined as constants; the 2D non-separable
4-subband bank is built from outer products, spatially flipped so that a
correlation with it computes a true convolution. Subband order [LL, LH,
HL, HH].
"""

from __future__ import annotations

import numpy as np

# pywt.Wavelet('bior4.4').filter_bank == (dec_lo, dec_hi, rec_lo, rec_hi)
_BIOR44 = np.array([
    [0.0, 0.03782845550726404, -0.023849465019556843, -0.11062440441843718,
     0.37740285561283066, 0.8526986790088938, 0.37740285561283066,
     -0.11062440441843718, -0.023849465019556843, 0.03782845550726404],
    [0.0, -0.06453888262869706, 0.04068941760916406, 0.41809227322161724,
     -0.7884856164055829, 0.41809227322161724, 0.04068941760916406,
     -0.06453888262869706, 0.0, 0.0],
    [0.0, -0.06453888262869706, -0.04068941760916406, 0.41809227322161724,
     0.7884856164055829, 0.41809227322161724, -0.04068941760916406,
     -0.06453888262869706, 0.0, 0.0],
    [0.0, -0.03782845550726404, -0.023849465019556843, 0.11062440441843718,
     0.37740285561283066, -0.8526986790088938, 0.37740285561283066,
     0.11062440441843718, -0.023849465019556843, -0.03782845550726404],
])


def _nonsep(w: np.ndarray) -> np.ndarray:
    """1D bank (2, L) -> 2D 4-subband bank (1, 4, L, L), flipped."""
    w1 = np.concatenate([w[:1], w[:1], w[1:], w[1:]])
    w2 = np.concatenate([w, w])
    return np.einsum("...i,...j->...ij", w1, w2)[None, :, ::-1, ::-1]


def filter_bank_2d(wname: str = "bior4.4"):
    """(Wa, Ws): the analysis bank (4, 1, L, L) and the synthesis bank
    (4, 1, L, L) with the flip undone, float32 numpy arrays. Only bior4.4,
    the one wavelet the reference uses, is built in."""
    if wname != "bior4.4":
        raise NotImplementedError(
            f"wavelet {wname!r}: only bior4.4 is ported (see ROADMAP.md)")
    Wa = np.swapaxes(_nonsep(_BIOR44[:2]), 0, 1)
    Ws = np.swapaxes(_nonsep(_BIOR44[2:]), 0, 1)[:, :, ::-1, ::-1]
    return Wa.astype(np.float32), Ws.astype(np.float32)
