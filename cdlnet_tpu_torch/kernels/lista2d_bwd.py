"""The reverse pass of the fused 2D (image) LISTA on hand-written CUDA kernels
(counterpart of cdlnet_tpu/kernels/lista2d.py::lista2d_fused_bwd, in the
soft-threshold and CSR prox modes, and lista2d_tiled_bwd.py::
lista2d_tiled_fused_bwd).

The reverse loop is the 3D one (kernels/lista3d_bwd.py::fused_bwd, whose
docstring states the algebra) on the (Hc, Wc) code grid of the 2D
stride-phase domain (kernels/lista2d.py), with the banks' adjoints
adjoint_bank(w, 2). dtau comes back per image, (K, N, M), and reaches t
through the differentiable tau = t0 + c t1 of phase_operands; the port
runs the N images of a batch as one kernel grid, so the JAX package's
folding of same-sigma images into one tall image has no counterpart. Per
training step of K iterations that is K syn_adjoint, K-1 syn_residual and
2K wgrad launches, on one kernel set for every crop size (the TPU
package's whole-image reverse kernel K6 and its banded one K8 alike).

lista2d_syn_adjoint and the CSR adjoints lista2d_syn_adjoint_csr(f2) run
the 2D analysis's tensor-core mainloop with an adjoint epilogue (the soft
threshold's subgradient, or the CSR prox's adjoint) and the 2D phase map
(kernels/csrc/lista2d.cu), and lista2d_wgrad the tensor-core weight
gradient of kernels/csrc/lista3d_bwd.cu at D = Qd = 1 (it reads no phase
map; the reverse loop passes it the phase rows the prep keeps,
lista3d_bwd.phase_rows). Each wrapper runs its CUDA kernel
on CUDA tensors, or raises; it runs the plain PyTorch version beside it
only for CPU tensors, and counts its launches in lista3d.launches under its
2D name. As in 3D, the histories may be bf16 (lista3d.hist_dtype): the ST
adjoint reads bf16 codes, the CSR adjoints bf16 codes and prox arguments,
and the weight gradient one bf16 operand as they are, each upcast once
where it is read; every sum is fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cdlnet_tpu_torch.core.ops import ST, csr_f2_jump
from cdlnet_tpu_torch.kernels.lista2d import _correlate_plain, lista2d_syn_residual
from cdlnet_tpu_torch.kernels.lista3d import (
    BF16,
    HISTORY,
    _check,
    _ptr,
    _raise_on,
    hist_launches,
    launches,
)
from cdlnet_tpu_torch.kernels.lista3d_bwd import _keep_rows, fused_bwd, launch_wgrad


def lista2d_syn_adjoint_plain(g, wt, z, geom, base=None, alpha=1.0):
    """Plain version of lista2d_syn_adjoint."""
    z = z.float()
    dz = alpha * _correlate_plain(g, wt, geom.off_a)
    if base is not None:
        dz = base + dz
    dv = torch.where(z != 0, dz, torch.zeros_like(dz))
    dtau = -(torch.sign(z) * dz).sum(dim=(2, 3))
    return dv, dtau


def prox_csr_adjoint_plain(dz, z, u, zp, tau, gam):
    """The adjoint of z = prox_csr(u, zp, tau, gam) (core/ops.py) for the
    cotangent dz, at the stored prox argument u and code z, elementwise in
    the TPU kernel's order (lista2d.py:548-563): sign(0) = 0 and each mask
    is `!= 0`. Returns (du, dzp, dtau, dgam) per element; tau and gam
    broadcast against the codes."""
    gw = torch.where(z != 0, dz, torch.zeros_like(dz))
    s_o = torch.sign(z)
    s_zp = torch.sign(zp)
    shift = zp + tau * s_zp
    inner = ST(u - shift, tau * gam)
    m_i = (inner != 0).to(dz.dtype)
    s_i = torch.sign(inner)
    du = gw * m_i
    dzp = gw * (1.0 - m_i)
    dtau = -s_o * gw + s_zp * dzp - gam * s_i * du
    dgam = -tau * s_i * du
    return du, dzp, dtau, dgam


def prox_csr_f2_adjoint_plain(dz, z, u, zp, za, tau, g1, g2):
    """The adjoint of z = prox_csr_f2(u, zp, za, tau, g1, g2) (core/ops.py)
    for the cotangent dz, as prox_csr_adjoint_plain (lista2d.py:564-603).
    Returns (du, dzp, dza, dtau, dg1, dg2) per element."""
    gw = torch.where(z != 0, dz, torch.zeros_like(dz))
    s_o = torch.sign(z)
    s_zp, s_za = torch.sign(zp), torch.sign(za)
    s_pa = torch.sign(zp - za)
    s_ap = -s_pa
    Ca = zp + tau * s_zp + tau * g2 * s_pa
    Cb = za + tau * s_za + tau * g1 * s_ap
    uCa = u - Ca
    s_uca = torch.sign(uCa)
    inner = ST(uCa, g1 * tau)
    m_i = (inner != 0).to(dz.dtype)
    s_i = torch.sign(inner)
    corr = tau * g1 * s_uca
    midder = ST(inner - Cb + corr, g2 * tau)
    m_m = (midder != 0).to(dz.dtype)
    s_m = torch.sign(midder)
    dtau = -s_o * gw
    gx = gw * m_m                # on (inner - Cb + corr)
    dtau = dtau + -g2 * s_m * gx
    dg2 = -tau * s_m * gx
    g_i = gx * m_i               # on (u - Ca)
    dtau = dtau + -g1 * s_i * g_i
    dg1 = -tau * s_i * g_i
    du = g_i
    dCa = -g_i
    dcorr = gx - gw
    dtau = dtau + g1 * s_uca * dcorr
    dg1 = dg1 + tau * s_uca * dcorr
    dCb = gw - gx
    dtau = dtau + (s_zp + g2 * s_pa) * dCa
    dg2 = dg2 + tau * s_pa * dCa
    dtau = dtau + (s_za + g1 * s_ap) * dCb
    dg1 = dg1 + tau * s_ap * dCb
    return du, dCa, dCb, dtau, dg1, dg2


def csr_prox_branches(u, zp, za, tau, g1, g2=None):
    """The branch of the CSR prox that an argument u falls in, elementwise:
    the signs that the prox adjoints (and the CSR adjoint kernels) read,
    sign(0) = 0, stacked on a new first dim. One-sided (za None, prox_csr
    toward zp with g1): the inner soft threshold's sign and the output's.
    Two-sided (prox_csr_f2): the sign of u - Ca, then of the inner, middle
    and outer soft thresholds. Two prox arguments whose branches are equal
    give the same adjoint masks; a code whose branch differs between a bf16
    and an fp32 u history (or two programs' fp32 ones) takes another piece
    of the prox, and its cotangent moves by the whole local gradient."""
    soft = lambda x, th: torch.sign(x) * torch.relu(x.abs() - th)
    sg = torch.sign
    u = u.float()
    if za is None:
        shift = zp + tau * sg(zp)
        inner = soft(u - shift, tau * g1)
        return torch.stack([sg(inner), sg(soft(inner + shift, tau))])
    Ca = csr_f2_jump(zp, za, tau, g2)
    Cb = za + tau * sg(za) + tau * g1 * sg(za - zp)
    inner = soft(u - Ca, g1 * tau)
    corr = tau * g1 * sg(u - Ca)
    midder = soft(inner - Cb + corr, g2 * tau)
    return torch.stack([sg(u - Ca), sg(inner), sg(midder), sg(soft(midder + Cb - corr, tau))])


def _synthesis_adjoint_plain(g, wt, geom, base, alpha):
    """dz = [base +] alpha * corr(g, wt, off_a)."""
    dz = alpha * _correlate_plain(g, wt, geom.off_a)
    return dz if base is None else base + dz


def _bank(b):
    return b[:, :, None, None]


def lista2d_syn_adjoint_csr_plain(g, wt, z, u, tau, gam, zp, dzp, geom, base=None,
                                  alpha=1.0):
    """Plain version of lista2d_syn_adjoint_csr (dzp updated in place; z
    and u may be bf16 histories, upcast once)."""
    dz = _synthesis_adjoint_plain(g, wt, geom, base, alpha)
    du, dzp_k, dtau, dgam = prox_csr_adjoint_plain(dz, z.float(), u.float(), zp, _bank(tau),
                                                   _bank(gam))
    dzp += dzp_k
    return du, dtau.sum(dim=(2, 3)), dgam.sum(dim=(2, 3))


def lista2d_syn_adjoint_csrf2_plain(g, wt, z, u, tau, gam1, gam2, zp, za, dzp, dza,
                                    geom, base=None, alpha=1.0):
    """Plain version of lista2d_syn_adjoint_csrf2 (dzp, dza updated in
    place; z and u may be bf16 histories, upcast once)."""
    dz = _synthesis_adjoint_plain(g, wt, geom, base, alpha)
    du, dzp_k, dza_k, dtau, dg1, dg2 = prox_csr_f2_adjoint_plain(
        dz, z.float(), u.float(), zp, za, _bank(tau), _bank(gam1), _bank(gam2))
    dzp += dzp_k
    dza += dza_k
    return du, dtau.sum(dim=(2, 3)), dg1.sum(dim=(2, 3)), dg2.sum(dim=(2, 3))


def lista2d_wgrad_plain(x, y, taps, off, alpha=1.0, rows=None):
    """Plain version of lista2d_wgrad: the conv2d of the padded x with y as
    its filters, batch and channels swapped."""
    x, y = x.float(), y.float()
    pad = []
    for q, o in zip(reversed(taps), reversed(off)):  # F.pad order: W, H
        pad += [-o, q - 1 + o]
    xp = F.pad(x, pad).transpose(0, 1)               # (I, N, H, W)
    dw = F.conv2d(xp, y.transpose(0, 1))             # (I, O, Qh, Qw)
    return _keep_rows(alpha * dw.permute(0, 2, 3, 1).contiguous(), rows)


def lista2d_syn_adjoint(g, wt, z, geom, base=None, alpha=1.0):
    """dz = [base +] alpha * corr(g, wt, off_a): the synthesis adjoint, and
    the soft threshold's subgradient at the codes z.

    g: (N, Cp, Hc, Wc) cotangent of a synthesis output; wt: (Cp, Qh, Qw,
    M), B_k's unflipped phase bank (adjoint_bank(ws_k, 2)); z: (N, M, Hc,
    Wc) the codes, fp32 or a bf16 history; base: (N, M, Hc, Wc) or None.
    Returns (dv = 1{z != 0} dz, dtau (N, M) = -sum sign(z) dz over the code
    grid), fp32, the per-block sums added in a fixed order.
    """
    if g.device.type == "cpu":
        return lista2d_syn_adjoint_plain(g, wt, z, geom, base=base, alpha=alpha)
    from cdlnet_tpu_torch.kernels._build import library

    lib = library()
    N, Cp, H, W = g.shape
    M = wt.shape[-1]
    Qh, Qw = wt.shape[1:3]
    _check("g", g, g.shape)
    _check("wt", wt, (Cp, Qh, Qw, M))
    _check("z", z, (N, M, H, W), HISTORY)
    if base is not None:
        _check("base", base, (N, M, H, W))
    dv = torch.empty(z.shape, dtype=g.dtype, device=g.device)
    dtau = torch.empty((N, M), dtype=g.dtype, device=g.device)
    parts = lib.lista2d_syn_adjoint_parts(N, Cp, M, H, W, Qh, Qw)
    work = torch.empty((max(parts, 1), N, M), dtype=g.dtype, device=g.device)
    err = lib.lista2d_syn_adjoint(
        _ptr(g), _ptr(wt), _ptr(base), _ptr(z), _ptr(work), _ptr(dv), _ptr(dtau),
        N, Cp, M, H, W, Qh, Qw, *geom.off_a, geom.s, *geom.P, *geom.pads,
        int(z.dtype == torch.bfloat16), float(alpha),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    _raise_on(err, "lista2d_syn_adjoint")
    launches["lista2d_syn_adjoint"] += 1
    hist_launches["lista2d_syn_adjoint"] += z.dtype == torch.bfloat16
    return dv, dtau


def lista2d_wgrad(x, y, taps, off, alpha=1.0, rows=None):
    """dw[i, q, o] = alpha * sum_{n,p} x[n, i, p+q+off] y[n, o, p]: the
    gradient of the bank of corr(x, ., off) whose output's cotangent is y.

    x: (N, I, Hc, Wc); y: (N, O, Hc, Wc), fp32, one of them may be a bf16
    history; taps: (Qh, Qw); off: the (H, W)
    tap offsets; rows: None (every row) or an (I, Qh, Qw) bool tensor of
    the phase rows to compute, the others written as zeros
    (lista3d_bwd.phase_rows). Returns dw (I, Qh, Qw, O), the bank layout;
    the cross-block reduction runs in a fixed order (bitwise repeatable).
    """
    if x.device.type == "cpu":
        return lista2d_wgrad_plain(x, y, taps, off, alpha=alpha, rows=rows)
    return launch_wgrad("lista2d_wgrad", x, y, tuple(taps), tuple(off), alpha, rows)


def _csr_adjoint(entry, g, wt, z, u, tau, gams, codes, dcodes, geom, base, alpha):
    """Launch the CSR adjoint kernel `entry` after checking its operands:
    z and u, the histories, both fp32 or both bf16; gams the (N, M) gamma
    banks, codes the neighbour codes and dcodes their cotangent buffers
    (N, M, Hc, Wc), which the kernel adds into, fp32. Returns (dv, dtau,
    *dgams)."""
    from cdlnet_tpu_torch.kernels._build import library

    lib = library()
    N, Cp, H, W = g.shape
    M = wt.shape[-1]
    Qh, Qw = wt.shape[1:3]
    _check("g", g, g.shape)
    _check("wt", wt, (Cp, Qh, Qw, M))
    _check("z", z, (N, M, H, W), HISTORY)
    _check("u", u, (N, M, H, W), (z.dtype,))
    named = [*zip(("zp", "za"), codes), *zip(("dzp", "dza"), dcodes)]
    if base is not None:
        named.append(("base", base))
    for name, t in named:
        _check(name, t, (N, M, H, W))
    for name, t in (("tau", tau), *zip(("gam1", "gam2"), gams)):
        _check(name, t, (N, M))
    bf16 = z.dtype in BF16
    dv = torch.empty(z.shape, dtype=g.dtype, device=g.device)
    sums = [torch.empty((N, M), dtype=g.dtype, device=g.device) for _ in range(1 + len(gams))]
    work = torch.empty((len(sums), lib.lista2d_syn_adjoint_csr_parts(H, W), N, M),
                       dtype=g.dtype, device=g.device)
    err = getattr(lib, entry)(
        _ptr(g), _ptr(wt), _ptr(base), _ptr(z), _ptr(u), _ptr(tau),
        *(_ptr(t) for t in gams), *(_ptr(t) for t in codes), _ptr(work), _ptr(dv),
        *(_ptr(t) for t in dcodes), *(_ptr(t) for t in sums),
        N, Cp, M, H, W, Qh, Qw, *geom.off_a, geom.s, *geom.P, *geom.pads,
        int(bf16), float(alpha), torch.cuda.current_stream(g.device).cuda_stream,
    )
    _raise_on(err, entry)
    launches[entry] += 1
    hist_launches[entry] += bf16
    return (dv, *sums)


def lista2d_syn_adjoint_csr(g, wt, z, u, tau, gam, zp, dzp, geom, base=None, alpha=1.0):
    """dz = [base +] alpha * corr(g, wt, off_a), then the adjoint of the
    one-sided CSR prox z = prox_csr(u, zp; tau, gam) at the stored prox
    argument u and code z (N, M, Hc, Wc): both fp32, or both bf16 histories.

    g, wt, base, alpha as in lista2d_syn_adjoint; tau, gam: (N, M); zp: the
    neighbour code; dzp: (N, M, Hc, Wc), which the cotangent of zp is added
    into; fp32. Returns (dv (N, M, Hc, Wc), dtau (N, M), dgam (N, M)), the
    per-block sums added in a fixed order.
    """
    if g.device.type == "cpu":
        return lista2d_syn_adjoint_csr_plain(g, wt, z, u, tau, gam, zp, dzp, geom,
                                             base=base, alpha=alpha)
    return _csr_adjoint("lista2d_syn_adjoint_csr", g, wt, z, u, tau, (gam,), (zp,),
                        (dzp,), geom, base, alpha)


def lista2d_syn_adjoint_csrf2(g, wt, z, u, tau, gam1, gam2, zp, za, dzp, dza, geom,
                              base=None, alpha=1.0):
    """As lista2d_syn_adjoint_csr for the two-sided prox z =
    prox_csr_f2(u, zp, za; tau, gam1, gam2), with the previous and
    following frames' codes zp, za, whose cotangents are added into dzp,
    dza. Returns (dv, dtau, dgam1, dgam2)."""
    if g.device.type == "cpu":
        return lista2d_syn_adjoint_csrf2_plain(g, wt, z, u, tau, gam1, gam2, zp, za,
                                               dzp, dza, geom, base=base, alpha=alpha)
    return _csr_adjoint("lista2d_syn_adjoint_csrf2", g, wt, z, u, tau, (gam1, gam2),
                        (zp, za), (dzp, dza), geom, base, alpha)


def lista2d_fused_bwd(dx2, y2, m2, banks, tau, z_hist, r_hist, geom, gams=(), codes=(),
                      u_hist=None, dz_out=None):
    """The reverse loop of the fused 2D LISTA (lista3d_bwd.fused_bwd, the
    3D algebra on the (Hc, Wc) grid) over the histories of
    lista2d.lista2d_loop(return_hists=True): 2K lista2d_wgrad, K
    lista2d_syn_adjoint and K-1 lista2d_syn_residual launches. dx2, y2, m2:
    (N, Cp, Hc, Wc) (m2 may be None); banks: (wa, ws) as from
    lista2d.phase_operands; tau: (K, N, M); dz_out: the cotangent of the
    returned code (N, M, Hc, Wc), or None. Returns (dwa, dws, dtau).

    CSR prox modes: the loop's `gams` and `codes` (one: prox_csr; two:
    prox_csr_f2) and its u_hist; the K adjoints are then
    lista2d_syn_adjoint_csr(f2), and the return is (dwa, dws, dtau, dgams,
    dcodes) with the gradients of the gamma banks (K, N, M) and of the
    neighbour codes."""
    kernels = (lista2d_syn_adjoint, lista2d_wgrad, lista2d_syn_residual)
    prox = None
    if codes:
        adjoint = lista2d_syn_adjoint_csr if len(codes) == 1 else lista2d_syn_adjoint_csrf2
        prox = (adjoint, u_hist, gams, codes)
    return fused_bwd(kernels, 2, dx2, y2, m2, banks, tau, z_hist, r_hist, geom,
                     dz_out=dz_out, prox=prox)
