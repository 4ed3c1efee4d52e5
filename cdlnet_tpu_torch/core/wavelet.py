"""2D wavelet filter banks (counterpart of the filter-bank part of
cdlnet_tpu/core/wavelet.py, which the MAD noise estimator reads).

The 1D bior4.4 bank (the CDF 9/7 pair, 10 taps each, zero-padded as pywt
aligns them) is inlined as constants; any other wavelet's 1D bank comes
from pywt when it is installed. The 2D non-separable 4-subband bank is
built from outer products, spatially flipped so that a correlation with it
computes a true convolution. Subband order [LL, LH, HL, HH].
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


def filter_bank_1d(wname: str):
    """(analysis (2, L), synthesis (2, L)) float64 1D banks: bior4.4 built
    in, any other name from pywt.Wavelet(wname).filter_bank when pywt is
    installed (it is optional), else NotImplementedError."""
    if wname == "bior4.4":
        fb = _BIOR44
    else:
        try:
            import pywt
        except ImportError as e:
            raise NotImplementedError(
                f"wavelet {wname!r} not built in and pywt unavailable") from e
        fb = np.asarray(pywt.Wavelet(wname).filter_bank, dtype=np.float64)
    return fb[:2], fb[2:]


def filter_bank_2d(wname: str = "bior4.4"):
    """(Wa, Ws): the analysis bank (4, 1, L, L) and the synthesis bank
    (4, 1, L, L) with the flip undone, float32 numpy arrays."""
    wa, ws = filter_bank_1d(wname)
    Wa = np.swapaxes(_nonsep(wa), 0, 1)
    Ws = np.swapaxes(_nonsep(ws), 0, 1)[:, :, ::-1, ::-1]
    return Wa.astype(np.float32), Ws.astype(np.float32)
