"""The reverse pass of the fused 3D LISTA on hand-written CUDA kernels
(counterpart of cdlnet_tpu/kernels/lista3d_bwd.py and
lista3d_bwd_resident.py).

The forward (kernels/lista3d.py) in the stride-phase domain, with
corr(x, w, off)[n,o,p] = sum_{i,q} w[i,q,o] x[n,i,p+q+off]:

  z_0   = ST(-corr(-y2, wa_0, off_a), tau_0)
  r_k   = m * corr(z_{k-1}, ws_k, off_s) - y2,   k = 1..K-1
  z_k   = ST(z_{k-1} - corr(r_k, wa_k, off_a), tau_k)
  x2    = corr(z_{K-1}, ws_0, off_s)

The adjoint of corr(., w, off) in its input is corr(., w*, -(Q-1) - off)
with w*[o,q,i] = w[i,Q-1-q,o] (adjoint_bank): the analysis's adjoint is a
synthesis-form correlation at off_s and the synthesis's an analysis-form
one at off_a. With dv_k = 1{z_k != 0} dz_k, the soft threshold's
subgradient read off the stored code, the reverse pass is

  init:   dz_{K-1} = ws_0*(dx2) [+ dz_out];   dws_0 = dx2 (*) z_{K-1}
  k = K-1..1:
          g         = m * wa_k*(dv_k)            (lista3d_syn_residual)
          dwa_k     = -dv_k (*) r_k              (lista3d_wgrad)
          dws_k     = -g (*) z_{k-1}             (lista3d_wgrad)
          dz_{k-1}  = dv_k - ws_k*(g)            (lista3d_syn_adjoint)
          dtau_{k-1} = -sum_p sign(z_{k-1}) dz_{k-1}
  k = 0:  dwa_0 = dv_0 (*) y2

where y (*) x is the weight gradient of the bank of corr(x, ., off) whose
output's cotangent is y, dz_out is the cotangent of the returned code (the
frame-recurrent CSR models carry it into the next frame), dtau_{K-1}
comes from the init step, and the sign
of g goes into the alpha of its two consumers. A synthesis bank's gradient
y (*) z at off_s is the adjoint_bank of z (*) y at off_a, so both weight
gradients run as products with the M code channels as outputs (the
kernel's efficient shape: its output channels are its tile's columns).
Per training step of K iterations that is K syn_adjoint, K-1 syn_residual
and 2K wgrad launches. The cotangents of the input, sigma and
mask are zero by construction: training differentiates with respect to
the parameters only (kernels/autodiff.py).

lista3d_syn_adjoint runs the 3D analysis's tensor-core mainloop with the
adjoint epilogue (kernels/csrc/lista3d.cu), lista3d_wgrad the tensor-core
weight gradient of kernels/csrc/lista3d_bwd.cu; the reverse loop passes the
weight gradient the phase rows the weight prep keeps (phase_rows), so the
structurally zero taps cost no products. Each wrapper runs its CUDA kernel
on CUDA tensors, or raises; it runs the plain PyTorch version beside it
only for CPU tensors, and counts its launches in lista3d.launches.

The histories may be bf16 (lista3d.hist_dtype): the loop passes them to
the kernels as they are, the codes to the synthesis adjoint (which reads
only their zeros and signs) and one operand of each weight gradient (dA's
r_{k-1}, dB's z_{k-1}), which stages it as bf16 and converts it exactly at
its products. The plain versions upcast a bf16 history first.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from cdlnet_tpu_torch.kernels.lista3d import (
    HISTORY,
    INVALID_CONFIGURATION,
    _check,
    _correlate_plain,
    _ptr,
    _raise_on,
    hist_launches,
    launches,
    lista3d_syn_residual,
)
from cdlnet_tpu_torch.ops import polyphase as pp

# the tensor-core weight gradient's row blocks: at most 128 phase rows (16
# n8 tiles) of at most 8 consecutive input channels (csrc/lista3d_bwd.cu)
WGRAD_BLOCK_ROWS, WGRAD_BLOCK_CHANNELS = 128, 8


def adjoint_bank(w: torch.Tensor, spatial: int = 3) -> torch.Tensor:
    """w* of a correlation bank (..., I, *Q, O) with `spatial` tap dims (3:
    Qd, Qh, Qw; 2: Qh, Qw): taps flipped, I and O swapped, (..., O, *Q, I),
    contiguous. corr(., w*, -(Q-1) - off) is the adjoint of corr(., w,
    off); prep_B2m_3d(W) == adjoint_bank(prep_A2m_3d(W)), prep_B2m_2d(W)
    == adjoint_bank(prep_A2m_2d(W), 2), and the other way round."""
    nd = w.dim()
    i_dim = nd - spatial - 2
    taps = list(range(i_dim + 1, nd - 1))
    return w.flip(taps).permute(*range(i_dim), nd - 1, *taps, i_dim).contiguous()


def lista3d_syn_adjoint_plain(g, wt, z, geom, base=None, alpha=1.0):
    """Plain version of lista3d_syn_adjoint."""
    z = z.float()
    dz = alpha * _correlate_plain(g, wt, geom.off_a)
    if base is not None:
        dz = base + dz
    dv = torch.where(z != 0, dz, torch.zeros_like(dz))
    dtau = -(torch.sign(z) * dz).sum(dim=(2, 3, 4))
    return dv, dtau


def phase_rows(geom, Cp: int, spatial: int) -> torch.Tensor:
    """The phase rows (i, q) of a (Cp, *Q, M) phase bank that the weight
    prep keeps: (Cp, *Q) bool, on the CPU, True where input channel i
    (phase i % s^spatial, ordered (c, a_1, ..)) at tap q maps to a tap of
    the kernel — the nonzero taps of ops/polyphase.py's valid mask. Every
    other entry of dA and dB reaches A and B through a zero. The same
    tensor for the same arguments (cached)."""
    return _phase_rows(geom.s, tuple(geom.P), tuple(geom.pads), Cp, spatial)


@functools.lru_cache(maxsize=None)
def _phase_rows(s, P, pads, Cp, spatial):
    valid = pp.phase_valid(P, pads, s, spatial)
    Q = valid.shape[spatial:]
    per = valid.reshape(s**spatial, *Q)
    return torch.from_numpy(np.tile(per, (Cp // s**spatial,) + (1,) * spatial))


def lista3d_wgrad_plain(x, y, taps, off, alpha=1.0, rows=None):
    """Plain version of lista3d_wgrad: the conv3d of the padded x with y as
    its filters, batch and channels swapped."""
    x, y = x.float(), y.float()
    pad = []
    for q, o in zip(reversed(taps), reversed(off)):  # F.pad order: W, H, D
        pad += [-o, q - 1 + o]
    xp = F.pad(x, pad).transpose(0, 1)               # (I, N, ...)
    dw = F.conv3d(xp, y.transpose(0, 1))             # (I, O, Qd, Qh, Qw)
    return _keep_rows(alpha * dw.permute(0, 2, 3, 4, 1).contiguous(), rows)


def _keep_rows(dw, rows):
    """dw (I, *Q, O) with the rows outside `rows` (I, *Q) set to zero."""
    return dw if rows is None else dw * rows.to(dw.device, dw.dtype)[..., None]


@functools.lru_cache(maxsize=None)
def _all_rows(shape):
    return torch.ones(shape, dtype=torch.bool)


def _row_table(rows, device):
    """The weight-gradient kernel's table of the phase rows `rows` (I, *Q)
    bool: (table on `device`, R rows, RB row blocks) — each row's slot or
    -1, the R rows in ascending order, and each row block's first slot
    then R; a block takes at most WGRAD_BLOCK_ROWS rows of at most
    WGRAD_BLOCK_CHANNELS consecutive channels, the blocks as few and as
    even as that allows. Built once per rows tensor and device (kept on the
    tensor)."""
    tables = rows.__dict__.setdefault("_wgrad_tables", {})
    key = str(device)
    if key not in tables:
        m = rows.reshape(rows.shape[0], -1).cpu().numpy().astype(bool)
        T = m.shape[1]
        slots = np.flatnonzero(m.reshape(-1))
        R = len(slots)
        slot_of = np.full(m.size, -1, np.int64)
        slot_of[slots] = np.arange(R)
        tiles = -(-R // 8)
        blocks = max(1, -(-R // WGRAD_BLOCK_ROWS))
        cap = 8 * -(-tiles // blocks)
        starts = [0]
        for j in range(1, R):
            first = slots[starts[-1]] // T
            if j - starts[-1] == cap or slots[j] // T - first >= WGRAD_BLOCK_CHANNELS:
                starts.append(j)
        table = np.concatenate([slot_of, slots, starts, [R]]).astype(np.int32)
        tables[key] = (torch.from_numpy(table).to(device), R, len(starts))
    return tables[key]


def wgrad_grid(N, I, O, grid, taps, rows=None):
    """The launch grid (row blocks, code blocks, splits) of lista3d_wgrad /
    lista2d_wgrad for x (N, I, *grid), y (N, O, *grid) on the current CUDA
    device."""
    from cdlnet_tpu_torch.kernels._build import library

    rows = _all_rows((I, *taps)) if rows is None else rows
    _, _, RB = _row_table(rows, "cpu")
    D, H, W = (1,) * (3 - len(grid)) + tuple(grid)
    out = (ctypes.c_int * 3)()
    _raise_on(library().lista3d_wgrad_grid(RB, O, N, D, H, W, out), "lista3d_wgrad_grid")
    return tuple(out)


def launch_wgrad(name, x, y, taps, off, alpha, rows):
    """Launch csrc/lista3d_bwd.cu's weight gradient on x (N, I, *grid), y
    (N, O, *grid) with 3 (video) or 2 (image, D = Qd = 1) grid dims, on
    the phase rows `rows` (I, *taps) bool or all of them; counts the launch
    under `name`. x or y (not both) may be a bf16 history. Returns dw (I,
    *taps, O), fp32."""
    from cdlnet_tpu_torch.kernels._build import library

    lib = library()
    N, I, *grid = x.shape
    O = y.shape[1]
    _check("x", x, x.shape, HISTORY)
    _check("y", y, (N, O, *grid), HISTORY)
    if x.dtype == y.dtype == torch.bfloat16:
        raise ValueError(f"{name}: one operand may be a bf16 history, not both")
    hist = 1 if x.dtype == torch.bfloat16 else (2 if y.dtype == torch.bfloat16 else 0)
    if rows is None:
        rows = _all_rows((I, *taps))
    elif tuple(rows.shape) != (I, *taps):
        raise ValueError(f"{name}: rows {tuple(rows.shape)}, expected {(I, *taps)}")
    table, R, RB = _row_table(rows, x.device)
    if R == 0:
        return torch.zeros((I, *taps, O), dtype=torch.float32, device=x.device)
    D, H, W = (1,) * (3 - len(grid)) + tuple(grid)
    (Qd, Qh, Qw), offs = (1,) * (3 - len(taps)) + tuple(taps), (0,) * (3 - len(off)) + tuple(off)
    out = (ctypes.c_int * 3)()
    _raise_on(lib.lista3d_wgrad_grid(RB, O, N, D, H, W, out), name)
    dw = torch.empty((I, *taps, O), dtype=torch.float32, device=x.device)
    work = torch.empty((out[2], R, O), dtype=torch.float32, device=x.device)
    err = lib.lista3d_wgrad(
        _ptr(x), _ptr(y), _ptr(table), _ptr(work), _ptr(dw),
        N, I, O, D, H, W, Qd, Qh, Qw, *offs, R, RB, hist,
        float(alpha), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err == INVALID_CONFIGURATION and Qd > 1:
        # x's stage over every depth tap exceeds a block's shared memory (the
        # stride-1 3D banks): each half of the depth taps is one call (each
        # split again if need be), on its slice of the rows
        h = (Qd + 1) // 2
        return torch.cat([
            launch_wgrad(name, x, y, (q1 - q0, Qh, Qw), (offs[0] + q0, *offs[1:]), alpha,
                         _depth_rows(rows, q0, q1))
            for q0, q1 in ((0, h), (h, Qd))], dim=1)
    _raise_on(err, name)
    launches[name] += 1
    hist_launches[name] += hist != 0
    return dw


def _depth_rows(rows, q0, q1):
    """rows[:, q0:q1] (I, Qd, Qh, Qw), the same tensor for the same slice
    (kept on rows, so that its row table is built once)."""
    cuts = rows.__dict__.setdefault("_depth_rows", {})
    if (q0, q1) not in cuts:
        cuts[(q0, q1)] = rows[:, q0:q1].contiguous()
    return cuts[(q0, q1)]


def lista3d_syn_adjoint(g, wt, z, geom, base=None, alpha=1.0):
    """dz = [base +] alpha * corr(g, wt, off_a): the synthesis adjoint, and
    the soft threshold's subgradient at the codes z.

    g: (N, Cp, Dc, Hc, Wc) cotangent of a synthesis output; wt: (Cp, Qd,
    Qh, Qw, M), B_k's unflipped phase bank (adjoint_bank of its synthesis
    bank); z: (N, M, Dc, Hc, Wc) the codes, fp32 or a bf16 history (the
    same dv and dtau as z.float()); base: (N, M, Dc, Hc, Wc) or None.
    Returns (dv = 1{z != 0} dz, dtau (N, M) = -sum sign(z) dz over the code
    grid), fp32, the per-block sums added in a fixed order.
    """
    if g.device.type == "cpu":
        return lista3d_syn_adjoint_plain(g, wt, z, geom, base=base, alpha=alpha)
    from cdlnet_tpu_torch.kernels._build import library

    lib = library()
    N, Cp, D, H, W = g.shape
    M = wt.shape[-1]
    Qd, Qh, Qw = wt.shape[1:4]
    _check("g", g, g.shape)
    _check("wt", wt, (Cp, Qd, Qh, Qw, M))
    _check("z", z, (N, M, D, H, W), HISTORY)
    if base is not None:
        _check("base", base, (N, M, D, H, W))
    dv = torch.empty(z.shape, dtype=g.dtype, device=g.device)
    dtau = torch.empty((N, M), dtype=g.dtype, device=g.device)
    parts = lib.lista3d_syn_adjoint_parts(N, Cp, M, D, H, W, Qd, Qh, Qw)
    work = torch.empty((max(parts, 1), N, M), dtype=g.dtype, device=g.device)
    err = lib.lista3d_syn_adjoint(
        _ptr(g), _ptr(wt), _ptr(base), _ptr(z), _ptr(work), _ptr(dv), _ptr(dtau),
        N, Cp, M, D, H, W, Qd, Qh, Qw, *geom.off_a, geom.s, *geom.P, *geom.pads,
        int(z.dtype == torch.bfloat16), float(alpha),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    _raise_on(err, "lista3d_syn_adjoint")
    launches["lista3d_syn_adjoint"] += 1
    hist_launches["lista3d_syn_adjoint"] += z.dtype == torch.bfloat16
    return dv, dtau


def lista3d_wgrad(x, y, taps, off, alpha=1.0, rows=None):
    """dw[i, q, o] = alpha * sum_{n,p} x[n, i, p+q+off] y[n, o, p]: the
    gradient of the bank of corr(x, ., off) whose output's cotangent is y.

    x: (N, I, Dc, Hc, Wc); y: (N, O, Dc, Hc, Wc), fp32, one of them may be a
    bf16 history (dA's r, dB's z); taps: (Qd, Qh, Qw); off:
    per-dim tap offsets; rows: None (every row) or an (I, Qd, Qh, Qw) bool
    tensor of the phase rows (i, q) to compute, the others written as
    zeros (phase_rows: the rows the weight prep keeps). Returns dw (I, Qd,
    Qh, Qw, O), the bank layout; the cross-block reduction runs in a fixed
    order (bitwise repeatable).
    """
    if x.device.type == "cpu":
        return lista3d_wgrad_plain(x, y, taps, off, alpha=alpha, rows=rows)
    return launch_wgrad("lista3d_wgrad", x, y, tuple(taps), tuple(off), alpha, rows)


def fused_bwd(kernels, spatial, dx2, y2, m2, banks, tau, z_hist, r_hist, geom,
              dz_out=None, prox=None):
    """The reverse loop of a fused LISTA over its stored histories (module
    docstring), on the kernels (syn_adjoint, wgrad, syn_residual) of a
    stride-phase domain with `spatial` tap dims (3: video, 2: images).

    dx2: (N, Cp, *grid) cotangent of x2; y2, m2 (or None): the forward's
    phase-domain input and mask; banks: (wa, ws) as from phase_operands;
    tau: (K, N, M) (its shape only is read: the subgradients come from the
    codes); z_hist, r_hist: from the loop's return_hists=True, fp32 or bf16
    (passed to the kernels as they are); dz_out:
    (N, M, *grid) cotangent of the returned code z_{K-1}, or None: it seeds
    dz_{K-1} (the base of the first adjoint call). Returns (dwa, dws,
    dtau), the gradients of wa, ws and tau.

    prox: None for the soft threshold, else (adjoint, u_hist, gams, codes)
    of a CSR prox mode: `adjoint` runs in syn_adjoint's place with the
    signature of kernels/lista2d_bwd.py::lista2d_syn_adjoint_csr(f2) — at
    iteration k it reads u_hist[k], the (K, N, M) gamma banks `gams` at k
    and the neighbour `codes`, and adds the codes' cotangents into buffers
    it is given. Then the return is (dwa, dws, dtau, dgams, dcodes): the
    gradients of each gamma bank (K, N, M) and of each neighbour code,
    summed over the K iterations.
    """
    syn_adjoint, wgrad, syn_residual = kernels
    wa, ws = banks
    K = wa.shape[0]
    taps = tuple(wa.shape[2:2 + spatial])
    wa_adj = adjoint_bank(wa, spatial)  # (K, M, Q, Cp): A_k* as a synthesis bank
    ws_adj = adjoint_bank(ws, spatial)  # (K, Cp, Q, M): B_k* as an analysis bank
    dwa = torch.empty_like(wa)
    dws = torch.empty_like(ws)
    dtau = torch.empty_like(tau)
    if prox is not None:
        prox_adjoint, u_hist, gams, codes = prox
        dgams = tuple(torch.empty_like(gm) for gm in gams)
        dcodes = tuple(torch.zeros_like(c) for c in codes)

    def adjoint(k, g, wt, base, alpha):
        """dv_k and dtau_k from dz_k = [base +] alpha * wt*(g), through the
        prox of iteration k."""
        if prox is None:
            return syn_adjoint(g, wt, z_hist[k], geom, base=base, alpha=alpha)
        dv, dtau_k, *dg = prox_adjoint(g, wt, z_hist[k], u_hist[k], tau[k],
                                       *(gm[k] for gm in gams), *codes, *dcodes,
                                       geom, base=base, alpha=alpha)
        for out, d in zip(dgams, dg):
            out[k] = d
        return dv, dtau_k

    # the phase rows the prep keeps, alike for dA and the swapped dB form
    # (whose adjoint bank maps its rows' flipped taps back onto B's)
    rows = phase_rows(geom, wa.shape[1], spatial)

    def syn_wgrad(z, g, alpha):  # == wgrad(z, g, taps, geom.off_s, alpha)
        return adjoint_bank(wgrad(g, z, taps, geom.off_a, alpha=alpha, rows=rows), spatial)

    dv, dtau[K - 1] = adjoint(K - 1, dx2, ws_adj[0], dz_out, 1.0)
    dws[0] = syn_wgrad(z_hist[K - 1], dx2, 1.0)
    for k in range(K - 1, 0, -1):
        dwa[k] = wgrad(r_hist[k - 1], dv, taps, geom.off_a, alpha=-1.0, rows=rows)
        g = syn_residual(dv, wa_adj[k], geom, mask=m2)
        dws[k] = syn_wgrad(z_hist[k - 1], g, -1.0)
        dv, dtau[k - 1] = adjoint(k - 1, g, ws_adj[k], dv, -1.0)
    dwa[0] = wgrad(y2, dv, taps, geom.off_a, rows=rows)
    if prox is None:
        return dwa, dws, dtau
    return dwa, dws, dtau, dgams, dcodes


def lista3d_fused_bwd(dx2, y2, m2, banks, tau, z_hist, r_hist, geom):
    """The reverse loop of the fused 3D LISTA (fused_bwd) over the
    histories of lista3d.lista3d_loop(return_hists=True): 2K wgrad, K
    syn_adjoint and K-1 syn_residual launches. Returns (dwa, dws, dtau)."""
    return fused_bwd((lista3d_syn_adjoint, lista3d_wgrad, lista3d_syn_residual), 3,
                     dx2, y2, m2, banks, tau, z_hist, r_hist, geom)
