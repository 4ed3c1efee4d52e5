"""Polyphase (space-to-depth) layout of the strided LISTA convs
(counterpart of the layout half of cdlnet_tpu/ops/polyphase.py).

Decompose a signal into its s^nd stride phases (space_to_depth); then

  analysis   conv_s(y, A)   ==  conv_1(y2, A2)       (stride 1)
  synthesis  convT_s(z, B)  ==  d2s(conv_1(z, B2t))  (stride 1)

with A2/B2t the phase-decomposed filter banks: for output position
u = s*U + a, the original tap dy satisfies dy = s*q + a + p with q the
phase-domain offset, so

  A2[m, (c,a,b,..), q_1, ..] = A[m, c, s*(q_1+q_lo)+a+p, ..]

(zero where the index falls outside [0, P)). The rewrite is exact.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _tup(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def space_to_depth(x: torch.Tensor, s: int, nd: int) -> torch.Tensor:
    """(N, C, *S) -> (N, C*s^nd, *S/s); phase index order (c, a_1, ..., a_nd)
    with a_i the phase along spatial dim i. Requires S_i % s == 0."""
    if s == 1:
        return x
    N, C = x.shape[:2]
    S = x.shape[2:]
    split = []
    for d in S:
        split += [d // s, s]
    x = x.reshape(N, C, *split)
    perm = [0, 1] + [2 + 2 * i + 1 for i in range(nd)] + [2 + 2 * i for i in range(nd)]
    return x.permute(perm).reshape(N, C * s**nd, *[d // s for d in S])


def depth_to_space(x: torch.Tensor, s: int, nd: int, C: int) -> torch.Tensor:
    """Inverse of space_to_depth: (N, C*s^nd, *Sc) -> (N, C, *Sc*s)."""
    if s == 1:
        return x
    N = x.shape[0]
    Sc = x.shape[2:]
    x = x.reshape(N, C, *([s] * nd), *Sc)
    perm = [0, 1]
    for i in range(nd):
        perm += [2 + nd + i, 2 + i]  # interleave (S_i/s, s)
    return x.permute(perm).reshape(N, C, *[d * s for d in Sc])


def _tap_ranges(P, p, s):
    """Phase-domain offset range [q_lo, q_hi] covering all phases a in [0,s).
    Valid taps satisfy 0 <= s*q + a + p <= P-1."""
    q_lo = min(int(np.ceil((-p - a) / s)) for a in range(s))
    q_hi = max(int(np.floor((P - 1 - p - a) / s)) for a in range(s))
    return q_lo, q_hi


def _phase_taps(P, p, s):
    """One dim's phase-domain taps: (q_lo, Q, dy) with dy[a, q] = s*(q + q_lo)
    + a + p the original tap of phase a at tap q (valid inside [0, P))."""
    lo, hi = _tap_ranges(P, p, s)
    Q = hi - lo + 1
    return lo, Q, s * (np.arange(Q)[None, :] + lo) + np.arange(s)[:, None] + p


def phase_valid(P, pads, s: int, nd: int) -> np.ndarray:
    """(s,)*nd + Q bool: whether phase (a_1..a_nd) at phase-domain tap
    (q_1..q_nd) maps to an original tap inside the kernel P, the valid mask
    that polyphase_weights applies to the gathered banks (False: a
    structurally zero tap)."""
    P, pads = _tup(P, nd), _tup(pads, nd)
    valid = np.ones((1,) * (2 * nd), bool)
    for i in range(nd):
        _, Q, dy = _phase_taps(P[i], pads[i], s)
        shape = [1] * (2 * nd)
        shape[i], shape[nd + i] = s, Q
        valid = valid & ((dy >= 0) & (dy < P[i])).reshape(shape)
    return valid


@functools.lru_cache(maxsize=None)
def _gather_operands(P, pads, s: int, nd: int, device, dtype):
    """polyphase_weights' index tensors and valid mask for one geometry,
    on `device`: (q_los, q_his, Qs, idx, valid). Built once, so the banks'
    gather copies nothing from the host per call (a CUDA graph that
    captured a training step reads these tensors at every replay)."""
    with torch.inference_mode(False):  # cached for autograd's use too
        return _build_gather_operands(P, pads, s, nd, device, dtype)


def _build_gather_operands(P, pads, s, nd, device, dtype):
    q_los, q_his, Qs, idx = [], [], [], []
    for i in range(nd):
        lo, Q, dy = _phase_taps(P[i], pads[i], s)
        q_los.append(lo)
        q_his.append(lo + Q - 1)
        Qs.append(Q)
        # dy laid out on axes (phase i, tap i) of a (s,)*nd + Q broadcast grid
        shape = [1] * (2 * nd)
        shape[i], shape[nd + i] = s, Q
        idx.append(torch.as_tensor(np.clip(dy, 0, P[i] - 1).reshape(shape), device=device))
    valid = torch.as_tensor(phase_valid(P, pads, s, nd), dtype=dtype, device=device)
    return q_los, q_his, Qs, tuple(idx), valid


def polyphase_weights(W: torch.Tensor, s: int, pads, nd: int):
    """Decompose stacked filters W (..., C, *P) into the phase-domain banks.

    Returns (A2, B2t, conv_pads_analysis, conv_pads_synthesis):
      A2:  (..., C*s^nd, *Q) analysis bank — conv1(y2, A2) == conv_s(y, W)
      B2t: A2 with its taps flipped — conv1(z, B2t) (in/out swapped) is the
           phase-domain convT_s(z, W)
    """
    P = tuple(W.shape[-nd:])
    C = W.shape[-nd - 1]
    lead = W.shape[: -nd - 1]
    q_los, q_his, Qs, idx, valid = _gather_operands(P, _tup(pads, nd), s, nd, W.device, W.dtype)

    # gather: A2[..., c, a_1..a_nd, q_1..q_nd] = W[..., c, dy_1, ..., dy_nd]
    A2 = W[(Ellipsis, *idx)] * valid
    A2 = A2.reshape(*lead, C * s**nd, *Qs)
    B2t = torch.flip(A2, dims=tuple(range(-nd, 0)))

    pad_a = [(-q_los[i], q_his[i]) for i in range(nd)]
    pad_s = [(q_his[i], -q_los[i]) for i in range(nd)]
    return A2, B2t, pad_a, pad_s
