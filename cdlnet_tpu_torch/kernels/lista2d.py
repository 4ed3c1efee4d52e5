"""The fused 2D (image) LISTA forward on hand-written CUDA kernels
(counterpart of cdlnet_tpu/kernels/lista2d.py::lista2d_fused and
lista2d_tiled.py::lista2d_tiled, soft-threshold mode).

The K-iteration loop runs in the stride-phase (space-to-depth) layout:
y2 = space_to_depth(yp) has Cp = C*s^2 channels on the (Hc, Wc) code grid,
and both strided convolutions become stride-1 correlations over Qh x Qw
phase taps. Each iteration is two kernel launches:

  lista2d_syn_residual   r = [mask *] (B_k^T z) [- y2]
  lista2d_ana_threshold  z = ST(z - A_k r, tau_k)

k = 0 is the analysis with r = -y2 and z = 0, and the final x2 = B_0^T z is
the synthesis without mask and y2: 2K launches per batch. The code tensor
z stays in device memory between launches, so one pair serves every image
size: the TPU package's whole-image VMEM kernel and its banded big-image
pair (and the VMEM budgets that route between them) have one counterpart
here. Tensors are (N, ch, Hc, Wc), contiguous, fp32. The thresholds are
per image: tau[k, n, m] = t[k,0,m] + c[n] * t[k,1,m].

Each wrapper runs its CUDA kernel on CUDA tensors, or raises; it runs the
plain PyTorch version beside it (the same function on F.conv2d over the
phase channels) only for CPU tensors. Launches count in
kernels.lista3d.launches, beside the 3D kernels', under the 2D names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cdlnet_tpu_torch.core.ops import ST
from cdlnet_tpu_torch.kernels.lista3d import (
    Geom,
    _check,
    _into,
    _out,
    _ptr,
    _raise_on,
    launches,
)
from cdlnet_tpu_torch.ops import polyphase as pp

_NOT_PORTED = ("is not ported to cdlnet_tpu_torch yet (the CSR models come "
               "later, see ROADMAP.md)")


def prep_A2m_2d(A: torch.Tensor, s: int, pads) -> torch.Tensor:
    """Phase-domain analysis banks in kernel layout (K, Cp, Qh, Qw, M)."""
    A2, _, _, _ = pp.polyphase_weights(A, s, pads, 2)  # (K, M, Cp, Qh, Qw)
    return A2.permute(0, 2, 3, 4, 1).contiguous()


def prep_B2m_2d(B: torch.Tensor, s: int, pads) -> torch.Tensor:
    """Phase-domain synthesis banks in kernel layout (K, M, Qh, Qw, Cp),
    taps flipped, so the synthesis is a correlation like the analysis."""
    _, B2t, _, _ = pp.polyphase_weights(B, s, pads, 2)  # (K, M, Cp, Qh, Qw)
    return B2t.permute(0, 1, 3, 4, 2).contiguous()


def _correlate_plain(x, wt, off):
    """out[n,o,p] = sum_{i,q} wt[i,q,o] * x[n,i,p+q+off], zero outside x.
    wt: (I, Qh, Qw, O); off: the (H, W) tap offsets."""
    Q = wt.shape[1:3]
    pad = []
    for q, o in zip(reversed(Q), reversed(off)):  # F.pad order: W, H
        pad += [-o, q - 1 + o]
    return F.conv2d(F.pad(x, pad), wt.permute(3, 0, 1, 2))


def lista2d_ana_threshold_plain(r, z, wa, tau, geom):
    """Plain version of lista2d_ana_threshold."""
    u = _correlate_plain(r, wa, geom.off_a)
    v = -u if z is None else z - u
    return ST(v, tau[:, :, None, None])


def lista2d_syn_residual_plain(z, ws, geom, mask=None, y=None):
    """Plain version of lista2d_syn_residual."""
    r = _correlate_plain(z, ws, geom.off_s)
    if mask is not None:
        r = mask * r
    return r if y is None else r - y


def lista2d_ana_threshold(r, z, wa, tau, geom, out=None):
    """z_new = ST(z - A_k r, tau): the analysis + soft threshold.

    r: (N, Cp, Hc, Wc) residual; z: (N, M, Hc, Wc) codes, or None for zeros
    (k = 0); wa: (Cp, Qh, Qw, M) from prep_A2m_2d; tau: (N, M); geom: the
    Geom of the banks; out: a contiguous (N, M, Hc, Wc) tensor to write the
    codes into (it may be z), or None for a new one. Returns the codes.
    """
    if r.device.type == "cpu":
        return _into(out, lista2d_ana_threshold_plain(r, z, wa, tau, geom))
    from cdlnet_tpu_torch.kernels._build import library

    lib = library()
    N, Cp, H, W = r.shape
    M = wa.shape[-1]
    Qh, Qw = wa.shape[1:3]
    _check("r", r, r.shape)
    _check("wa", wa, (Cp, Qh, Qw, M))
    _check("tau", tau, (N, M))
    if z is not None:
        _check("z", z, (N, M, H, W))
    out = _out(out, (N, M, H, W), r)
    err = lib.lista2d_ana_threshold(
        _ptr(r), _ptr(wa), _ptr(z), _ptr(tau), _ptr(out),
        N, Cp, M, H, W, Qh, Qw, *geom.off_a, geom.s, *geom.P, *geom.pads,
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    _raise_on(err, "lista2d_ana_threshold")
    launches["lista2d_ana_threshold"] += 1
    return out


def lista2d_syn_residual(z, ws, geom, mask=None, y=None, out=None):
    """r = [mask *] (B_k^T z) [- y]: the synthesis (+ residual).

    z: (N, M, Hc, Wc); ws: (M, Qh, Qw, Cp) from prep_B2m_2d; geom: the Geom
    of the banks; mask, y: (N, Cp, Hc, Wc) or None; out: as in
    lista2d_ana_threshold (not z). Returns (N, Cp, Hc, Wc).
    """
    if z.device.type == "cpu":
        return _into(out, lista2d_syn_residual_plain(z, ws, geom, mask=mask, y=y))
    from cdlnet_tpu_torch.kernels._build import library

    lib = library()
    N, M, H, W = z.shape
    Cp = ws.shape[-1]
    Qh, Qw = ws.shape[1:3]
    _check("z", z, z.shape)
    _check("ws", ws, (M, Qh, Qw, Cp))
    for name, t in (("mask", mask), ("y", y)):
        if t is not None:
            _check(name, t, (N, Cp, H, W))
    out = _out(out, (N, Cp, H, W), z)
    err = lib.lista2d_syn_residual(
        _ptr(z), _ptr(ws), _ptr(mask), _ptr(y), _ptr(out),
        N, M, Cp, H, W, Qh, Qw, *geom.off_s,
        torch.cuda.current_stream(z.device).cuda_stream,
    )
    _raise_on(err, "lista2d_syn_residual")
    launches["lista2d_syn_residual"] += 1
    return out


def phase_operands(yp, A, B, t, c, stride, mask=None):
    """The fused loop's operands in the phase domain: (y2, m2, wa, ws, tau,
    geom) with y2 = space_to_depth(yp), m2 the mask's (or None), the banks
    wa = prep_A2m_2d(A) (K, Cp, Qh, Qw, M) and ws = prep_B2m_2d(B) (K, M,
    Qh, Qw, Cp), and tau[k, n] = t[k,0] + c[n] * t[k,1] (K, N, M)."""
    N, C, H, W = yp.shape
    P = tuple(A.shape[-2:])
    s = stride
    if H % s or W % s:
        raise ValueError(f"image {(H, W)} is not divisible by stride {s}")
    pads = tuple((p - 1) // 2 for p in P)
    geom = Geom(s, P, pads)
    wa = prep_A2m_2d(A, s, pads)
    ws = prep_B2m_2d(B, s, pads)
    y2 = pp.space_to_depth(yp, s, 2).contiguous()  # (N, Cp, Hc, Wc)
    m2 = (
        pp.space_to_depth(mask.expand(yp.shape), s, 2).contiguous()
        if mask is not None
        else None
    )
    c_arr = torch.as_tensor(c, dtype=yp.dtype, device=yp.device).reshape(-1)
    c_arr = c_arr.expand(N)
    tau = t[None, :, 0, :, 0, 0] + c_arr[:, None, None] * t[None, :, 1, :, 0, 0]
    return y2, m2, wa, ws, tau.transpose(0, 1).contiguous(), geom


def lista2d_loop(y2, m2, wa, ws, tau, geom, return_hists=False):
    """The 2K kernel launches of the fused loop on phase-domain operands
    (phase_operands). Returns (x2, z, hists): x2 = B_0^T z (N, Cp, Hc, Wc),
    z the final codes (N, M, Hc, Wc), and with return_hists the fp32
    histories (z_hist (K, N, M, Hc, Wc) of every z_k, r_hist (K-1, N, Cp,
    Hc, Wc) of every residual r_k) that the reverse pass reads, else None.
    Without histories z and r are updated in place."""
    K, M = wa.shape[0], wa.shape[-1]
    z_hist = r_hist = None
    if return_hists:  # the kernels write each z_k and r_k into its slice
        N, _, H, W = y2.shape
        z_hist = y2.new_empty((K, N, M, H, W))
        r_hist = y2.new_empty((K - 1, *y2.shape))
    z = lista2d_ana_threshold(-y2, None, wa[0], tau[0], geom,
                              out=None if z_hist is None else z_hist[0])
    r = torch.empty_like(y2) if r_hist is None else None
    for k in range(1, K):
        r = lista2d_syn_residual(z, ws[k], geom, mask=m2, y=y2,
                                 out=r if r_hist is None else r_hist[k - 1])
        z = lista2d_ana_threshold(r, z, wa[k], tau[k], geom,
                                  out=z if z_hist is None else z_hist[k])
    x2 = lista2d_syn_residual(z, ws[0], geom)
    return x2, z, (None if z_hist is None else (z_hist, r_hist))


def lista2d_fused(yp, A, B, t, c, stride=1, mask=None, return_z=False,
                  g=None, z_prev=None, g2=None, z_after=None,
                  return_hist=False):
    """Fused K-iteration 2D LISTA + final dictionary synthesis.

    yp: (N, C, H, W) pre-processed input (H, W divisible by stride); A, B:
    (K, M, C, P, P); t: (K, 2, M, 1, 1); c: scalar or (N, 1, 1, 1) threshold
    scale; mask: optional (N, C, H, W) observation mask (JDD). Returns
    (xphat (N, C, H, W), z (N, M, H/s, W/s) or None) — ops.lista.lista_2d +
    conv_transpose2d(B[0]) to fp32 reassociation tolerance — and with
    return_hist a third item, the fp32 histories (z_hist (K, N, M, Hc, Wc),
    r_hist (K-1, N, Cp, Hc, Wc)) of lista2d_loop, in the phase domain: r_k
    has the space_to_depth layout of y2 (channel c*s^2 + a_h*s + a_w). The
    JAX kernel's one (N, K, Mp8+Rp8, Hc*Wc) array holds the same values
    (z_k in rows [0:M), r_k in rows [Mp8:Mp8+Cp) of its step k). No
    gradient flows through the kernels here: training goes through
    autodiff.lista2d_fused_diff. The CSR prox modes (g, z_prev, g2,
    z_after) raise."""
    if any(v is not None for v in (g, z_prev, g2, z_after)):
        raise NotImplementedError(f"the CSR prox modes of lista2d_fused {_NOT_PORTED}")
    y2, m2, wa, ws, tau, geom = phase_operands(yp, A, B, t, c, stride, mask)
    x2, z, hists = lista2d_loop(y2, m2, wa, ws, tau, geom, return_hist)
    xphat = pp.depth_to_space(x2, stride, 2, yp.shape[1])
    if return_hist:
        return xphat, (z if return_z else None), hists
    return xphat, (z if return_z else None)
