"""The fused 2D (image) LISTA forward on hand-written CUDA kernels
(counterpart of cdlnet_tpu/kernels/lista2d.py::lista2d_fused and
lista2d_tiled.py::lista2d_tiled, in the soft-threshold and CSR prox modes).

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

The frame-recurrent CSR models replace the soft threshold by a prox that
pulls z toward neighbour-frame codes (core/ops.py::prox_csr/prox_csr_f2):
the analysis is then lista2d_ana_csr (one code z_prev) or lista2d_ana_csrf2
(z_prev and z_after), with gamma banks formed like tau,
gam[k, n, m] = g[k,0,m] + c[n] * g[k,1,m]; the synthesis is unchanged.
For training, the CSR analyses also write the prox argument
u_k = z_{k-1} - A_k r_k of every iteration (the u history): the two-sided
prox's internals cannot be read back from its output, so the reverse
kernels (kernels/lista2d_bwd.py) recompute them from u_k.

Each wrapper runs its CUDA kernel on CUDA tensors, or raises; it runs the
plain PyTorch version beside it (the same function on F.conv2d over the
phase channels) only for CPU tensors. Launches count in
kernels.lista3d.launches, beside the 3D kernels', under the 2D names. Every
kernel here runs on the tensor cores in 3xTF32 (csrc/lista2d_mma.cuh; the
CSR analyses are the ST analysis with the prox in its epilogue), and the
launches split the codes where the code grid is small, so that one 128^2
image fills the card: launch_grid says how.

The loop's training histories follow hist_dtype() (bf16 by default, the
JAX package's lista2d.py::hist_dtype, whose counterpart this module
re-exports), in every prox mode, with the fp32 carries and in-epilogue bf16
copies of the 3D loop (kernels/lista3d.py): in a CSR mode the analysis also
stores the prox argument's rounded copy into the bf16 u history.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cdlnet_tpu_torch.core.ops import ST, csr_f2_jump, prox_csr, prox_csr_f2
from cdlnet_tpu_torch.kernels.lista3d import (  # noqa: F401 (hist_dtype: re-exported)
    BF16,
    FP32,
    Geom,
    _check,
    _hist,
    _into,
    _out,
    _ptr,
    _raise_on,
    hist_dtype,
    hist_launches,
    launches,
    per_sample,
)
from cdlnet_tpu_torch.ops import polyphase as pp
from cdlnet_tpu_torch.utils import trace_span

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


def ana_argument_plain(r, z, wa, geom):
    """v = z - A_k r (z None: zeros), the argument of the analysis' prox."""
    u = _correlate_plain(r, wa, geom.off_a)
    return -u if z is None else z - u


def lista2d_ana_threshold_plain(r, z, wa, tau, geom):
    """Plain version of lista2d_ana_threshold."""
    return ST(ana_argument_plain(r, z, wa, geom), tau[:, :, None, None])


def lista2d_syn_residual_plain(z, ws, geom, mask=None, y=None):
    """Plain version of lista2d_syn_residual."""
    r = _correlate_plain(z, ws, geom.off_s)
    if mask is not None:
        r = mask * r
    return r if y is None else r - y


def _argument_into(u_out, r, z, wa, geom):
    """ana_argument_plain, also copied into u_out unless it is None."""
    v = ana_argument_plain(r, z, wa, geom)
    if u_out is not None:
        u_out.copy_(v)
    return v


def lista2d_ana_csr_plain(r, z, wa, tau, gam, zp, geom, u_out=None):
    """Plain version of lista2d_ana_csr."""
    return prox_csr(_argument_into(u_out, r, z, wa, geom), zp, tau[:, :, None, None],
                    gam[:, :, None, None])


def lista2d_ana_csrf2_plain(r, z, wa, tau, gam1, gam2, zp, za, geom, u_out=None):
    """Plain version of lista2d_ana_csrf2."""
    return prox_csr_f2(_argument_into(u_out, r, z, wa, geom), zp, za,
                       tau[:, :, None, None], gam1[:, :, None, None],
                       gam2[:, :, None, None])


def csrf2_jump_gap(v, zp, za, tau, gam2):
    """|v - Ca| per code: how far the prox argument v (N, M, Hc, Wc) lies
    from Ca, where prox_csr_f2 jumps by up to 2 tau gam1 (tau, gam2: (N,
    M)). A kernel and its plain version, whose v differ by fp32
    reassociation, can land on the two sides of the jump where it is
    small."""
    return (v - csr_f2_jump(zp, za, tau[:, :, None, None], gam2[:, :, None, None])).abs()


def _analysis(entry, r, z, wa, tau, geom, out, banks=(), codes=(), u_out=None, hist=None):
    """Launch the analysis kernel `entry` after checking its operands: the
    ST arguments, then the (N, M) gamma `banks` and the (N, M, Hc, Wc)
    neighbour `codes` of a CSR mode, each a (name, tensor) pair, a CSR
    mode's u_out, where its kernel stores the prox argument (None: NULL,
    not stored; bf16 exactly where `hist` is given), and the bf16 history
    slice `hist` that takes the codes' rounded copy (None: NULL)."""
    from cdlnet_tpu_torch.kernels._build import library

    lib = library()
    N, Cp, H, W = r.shape
    M = wa.shape[-1]
    Qh, Qw = wa.shape[1:3]
    _check("r", r, r.shape)
    _check("wa", wa, (Cp, Qh, Qw, M))
    for name, t in (("tau", tau), *banks):
        _check(name, t, (N, M))
    for name, t in ((("z", z),) if z is not None else ()) + tuple(codes):
        _check(name, t, (N, M, H, W))
    out = _out(out, (N, M, H, W), r)
    if u_out is not None:
        _check("u_out", u_out, (N, M, H, W), FP32 if hist is None else BF16)
    # after the codes: a CSR kernel's u_out, then the history slice
    extra = (_ptr(u_out),) if banks else ()
    err = getattr(lib, entry)(
        _ptr(r), _ptr(wa), _ptr(z), _ptr(tau), *(_ptr(t) for _, t in banks),
        *(_ptr(t) for _, t in codes), _ptr(out), *extra, _hist(hist, (N, M, H, W)),
        N, Cp, M, H, W, Qh, Qw, *geom.off_a, geom.s, *geom.P, *geom.pads,
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    _raise_on(err, entry)
    launches[entry] += 1
    hist_launches[entry] += hist is not None
    return out


def lista2d_ana_threshold(r, z, wa, tau, geom, out=None, hist=None):
    """z_new = ST(z - A_k r, tau): the analysis + soft threshold.

    r: (N, Cp, Hc, Wc) residual; z: (N, M, Hc, Wc) codes, or None for zeros
    (k = 0); wa: (Cp, Qh, Qw, M) from prep_A2m_2d; tau: (N, M); geom: the
    Geom of the banks; out: a contiguous (N, M, Hc, Wc) tensor to write the
    codes into (it may be z), or None for a new one; hist: a contiguous bf16
    (N, M, Hc, Wc) history slice that also takes the codes, rounded to
    nearest even, or None. Returns the codes.
    """
    if r.device.type == "cpu":
        return _into(out, lista2d_ana_threshold_plain(r, z, wa, tau, geom), hist)
    return _analysis("lista2d_ana_threshold", r, z, wa, tau, geom, out, hist=hist)


def lista2d_ana_csr(r, z, wa, tau, gam, zp, geom, out=None, u_out=None, hist=None):
    """z_new = prox_csr(z - A_k r, zp; tau, gam): the analysis + the
    one-sided CSR prox toward the neighbour code zp (N, M, Hc, Wc, fp32, not
    `out`), gam (N, M); u_out: a contiguous (N, M, Hc, Wc) tensor that
    takes the prox argument z - A_k r (the u history), or None; hist: a
    contiguous bf16 (N, M, Hc, Wc) history slice that also takes the codes
    rounded to nearest even, or None, and where it is given u_out is bf16
    and takes the prox argument rounded; the rest as in
    lista2d_ana_threshold."""
    if r.device.type == "cpu":
        return _into(out, lista2d_ana_csr_plain(r, z, wa, tau, gam, zp, geom, u_out), hist)
    return _analysis("lista2d_ana_csr", r, z, wa, tau, geom, out,
                     banks=(("gam", gam),), codes=(("zp", zp),), u_out=u_out, hist=hist)


def lista2d_ana_csrf2(r, z, wa, tau, gam1, gam2, zp, za, geom, out=None, u_out=None,
                      hist=None):
    """z_new = prox_csr_f2(z - A_k r, zp, za; tau, gam1, gam2): the analysis
    + the two-sided CSR prox with the previous and following frames' codes
    zp, za (N, M, Hc, Wc); the rest as in lista2d_ana_csr."""
    if r.device.type == "cpu":
        return _into(out, lista2d_ana_csrf2_plain(r, z, wa, tau, gam1, gam2, zp, za,
                                                  geom, u_out), hist)
    return _analysis("lista2d_ana_csrf2", r, z, wa, tau, geom, out,
                     banks=(("gam1", gam1), ("gam2", gam2)),
                     codes=(("zp", zp), ("za", za)), u_out=u_out, hist=hist)


def lista2d_syn_residual(z, ws, geom, mask=None, y=None, out=None, hist=None):
    """r = [mask *] (B_k^T z) [- y]: the synthesis (+ residual).

    z: (N, M, Hc, Wc); ws: (M, Qh, Qw, Cp) from prep_B2m_2d; geom: the Geom
    of the banks; mask, y: (N, Cp, Hc, Wc) or None; out, hist: as in
    lista2d_ana_threshold (out not z). Returns (N, Cp, Hc, Wc).
    """
    if z.device.type == "cpu":
        return _into(out, lista2d_syn_residual_plain(z, ws, geom, mask=mask, y=y), hist)
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
        _ptr(z), _ptr(ws), _ptr(mask), _ptr(y), _ptr(out), _hist(hist, out.shape),
        N, M, Cp, H, W, Qh, Qw, *geom.off_s,
        torch.cuda.current_stream(z.device).cuda_stream,
    )
    _raise_on(err, "lista2d_syn_residual")
    launches["lista2d_syn_residual"] += 1
    hist_launches["lista2d_syn_residual"] += hist is not None
    return out


def launch_grid(synthesis, N, I, O, H, W, Qh, Qw):
    """The launch that lista2d_syn_residual (synthesis) or
    lista2d_ana_threshold makes on the current card for a call on an
    (N, I, H, W) input with O output channels and Qh x Qw phase taps:
    {"grid": (x, y, z), "blocks": x * y * z, "rows": code rows a block, and
    "split" (the blocks of a cluster, which split the codes) or "codes"
    (the codes of a block)}."""
    from cdlnet_tpu_torch.kernels._build import library

    out = (ctypes.c_int * 5)()
    err = library().lista2d_launch_grid(int(synthesis), N, I, O, H, W, Qh, Qw, out)
    _raise_on(err, "lista2d_launch_grid")
    grid = tuple(out[:3])
    return {"grid": grid, "blocks": grid[0] * grid[1] * grid[2], "rows": out[4],
            ("split" if synthesis else "codes"): out[3]}


def phase_operands(yp, A, B, t, c, stride, mask=None):
    """The fused loop's operands in the phase domain: (y2, m2, wa, ws, tau,
    geom) with y2 = space_to_depth(yp), m2 the mask's (or None), the banks
    wa = prep_A2m_2d(A) (K, Cp, Qh, Qw, M) and ws = prep_B2m_2d(B) (K, M,
    Qh, Qw, Cp), and tau[k, n] = t[k,0] + c[n] * t[k,1] (K, N, M)."""
    with trace_span("lista2d_operands"):
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
        tau = threshold_bank(t, c, N, yp)
        return y2, m2, wa, ws, tau, geom


def threshold_bank(t, c, N, like):
    """Per-image thresholds (K, N, M) of a (K, 2, M, 1, 1) bank: t[k,0] +
    c[n] * t[k,1] — tau from t, and the CSR gamma banks from g, g1, g2.
    c: a scalar or N values; `like` gives the device and dtype."""
    c_arr = per_sample(c, N, like)
    bank = t[None, :, 0, :, 0, 0] + c_arr[:, None, None] * t[None, :, 1, :, 0, 0]
    return bank.transpose(0, 1).contiguous()


def lista2d_loop(y2, m2, wa, ws, tau, geom, return_hists=False, gams=(), codes=(),
                 hists_dtype=None):
    """The 2K kernel launches of the fused loop on phase-domain operands
    (phase_operands). Returns (x2, z, hists): x2 = B_0^T z (N, Cp, Hc, Wc),
    z the final codes (N, M, Hc, Wc), and with return_hists the histories
    (z_hist (K, N, M, Hc, Wc) of every z_k, r_hist (K-1, N, Cp, Hc, Wc) of
    every residual r_k) that the reverse pass reads, else None. Without
    histories z and r are updated in place.

    hists_dtype: the histories' dtype, None for hist_dtype(): fp32, the
    kernels write each z_k and r_k into its slice; bf16, z and r are
    updated in place as without histories, and each launch also stores its
    output's rounded copy into the slice (the outputs bitwise the fp32
    mode's).

    CSR prox modes: `codes` holds the neighbour codes (N, M, Hc, Wc), fp32
    — one (prox_csr) or two (z_prev, z_after: prox_csr_f2) — and `gams` as
    many (K, N, M) gamma banks (threshold_bank); the analysis is then
    lista2d_ana_csr / lista2d_ana_csrf2. With return_hists they add a third
    history at the same dtype, u_hist (K, N, M, Hc, Wc): the prox argument
    u_k = z_{k-1} - A_k r_k of every iteration (u_0 = A_0 y2), which the
    CSR reverse kernels recompute the prox's internals from (in bf16, each
    analysis stores u_k's rounded copy beside the codes')."""
    with trace_span("lista2d_loop"):
        K, M = wa.shape[0], wa.shape[-1]
        if len(gams) != len(codes) or len(codes) > 2:
            raise ValueError(f"{len(codes)} neighbour codes with {len(gams)} gamma banks")

        z_hist = r_hist = u_hist = None
        bf16 = False
        if return_hists:
            dtype = hist_dtype() if hists_dtype is None else hists_dtype
            bf16 = dtype == torch.bfloat16
            N, _, H, W = y2.shape
            z_hist = y2.new_empty((K, N, M, H, W), dtype=dtype)
            r_hist = y2.new_empty((K - 1, *y2.shape), dtype=dtype)
            if codes:
                u_hist = y2.new_empty((K, N, M, H, W), dtype=dtype)

        def analysis(r, z, k, out, hist):
            if not codes:
                return lista2d_ana_threshold(r, z, wa[k], tau[k], geom, out=out, hist=hist)
            u_out = None if u_hist is None else u_hist[k]
            if len(codes) == 1:
                return lista2d_ana_csr(r, z, wa[k], tau[k], gams[0][k], codes[0], geom,
                                       out=out, u_out=u_out, hist=hist)
            return lista2d_ana_csrf2(r, z, wa[k], tau[k], gams[0][k], gams[1][k], *codes,
                                     geom, out=out, u_out=u_out, hist=hist)

        # fp32 histories: each launch writes its slice, which the next one
        # reads; else z and r are carries, updated in place (the first analysis
        # makes z), and bf16 histories take each launch's rounded copy
        slices = z_hist is not None and not bf16
        zh = lambda k: z_hist[k] if bf16 else None
        rh = lambda k: r_hist[k] if bf16 else None
        z = analysis(-y2, None, 0, z_hist[0] if slices else None, zh(0))
        r = None if slices else torch.empty_like(y2)
        for k in range(1, K):
            r = lista2d_syn_residual(z, ws[k], geom, mask=m2, y=y2,
                                     out=r_hist[k - 1] if slices else r, hist=rh(k - 1))
            z = analysis(r, z, k, z_hist[k] if slices else z, zh(k))
        x2 = lista2d_syn_residual(z, ws[0], geom)
        if z_hist is None:
            return x2, z, None
        return x2, z, (z_hist, r_hist) if u_hist is None else (z_hist, r_hist, u_hist)


def csr_mode(g, z_prev, g2, z_after):
    """(codes, banks) of lista2d_loop for the CSR keywords, as the JAX
    package maps them: () for none (soft threshold), (z_prev,) with g,
    (z_after,) with g2 (the one-sided prox toward the following frame, in
    z_prev's slots), or both codes with (g, g2). Raises ValueError when a
    code comes without its bank."""
    codes, banks = (), ()
    if z_prev is not None and z_after is not None:
        codes, banks = (z_prev, z_after), (g, g2)
    elif z_prev is not None:
        codes, banks = (z_prev,), (g,)
    elif z_after is not None:  # one-sided on the following frame: gamma = g2
        codes, banks = (z_after,), (g2,)
    if any(b is None for b in banks):
        raise ValueError("each neighbour code needs its gamma bank (g for z_prev, "
                         "g2 for z_after)")
    return codes, banks


def lista2d_fused(yp, A, B, t, c, stride=1, mask=None, return_z=False,
                  g=None, z_prev=None, g2=None, z_after=None,
                  return_hist=False, hists_dtype=None):
    """Fused K-iteration 2D LISTA + final dictionary synthesis.

    yp: (N, C, H, W) pre-processed input (H, W divisible by stride); A, B:
    (K, M, C, P, P); t: (K, 2, M, 1, 1); c: scalar or (N, 1, 1, 1) threshold
    scale; mask: optional (N, C, H, W) observation mask (JDD). Returns
    (xphat (N, C, H, W), z (N, M, H/s, W/s) or None) — ops.lista.lista_2d +
    conv_transpose2d(B[0]) to fp32 reassociation tolerance — and with
    return_hist a third item, the histories (z_hist (K, N, M, Hc, Wc),
    r_hist (K-1, N, Cp, Hc, Wc)) of lista2d_loop at hists_dtype (None:
    hist_dtype()), in the phase domain: r_k
    has the space_to_depth layout of y2 (channel c*s^2 + a_h*s + a_w). The
    JAX kernel's one (N, K, Mp8+Rp8, Hc*Wc) array holds the same values
    (z_k in rows [0:M), r_k in rows [Mp8:Mp8+Cp) of its step k; in a CSR
    mode u_k in rows [Mp8:Mp8+M) and r_k after them). No gradient flows
    through the kernels here: training goes through
    autodiff.lista2d_fused_diff, and for the CSR models
    autodiff.csr_fused_2d_train.

    CSR prox modes (the frame-recurrent models), mapped as the JAX
    package maps them: z_prev (N, M, Hc, Wc) with the gamma bank g (K, 2, M,
    1, 1) runs the one-sided prox_csr; z_after with g2 alone runs the same
    prox toward z_after with g2; both codes (and g, g2) run the two-sided
    prox_csr_f2 (csr_mode). With return_hist their histories hold a third
    one, u_hist (K, N, M, Hc, Wc), the prox argument of every iteration."""
    codes, banks = csr_mode(g, z_prev, g2, z_after)
    y2, m2, wa, ws, tau, geom = phase_operands(yp, A, B, t, c, stride, mask)
    gams = tuple(threshold_bank(b, c, yp.shape[0], yp) for b in banks)
    codes = tuple(z.contiguous() for z in codes)
    x2, z, hists = lista2d_loop(y2, m2, wa, ws, tau, geom, return_hist, gams=gams,
                                codes=codes, hists_dtype=hists_dtype)
    xphat = pp.depth_to_space(x2, stride, 2, yp.shape[1])
    if return_hist:
        return xphat, (z if return_z else None), hists
    return xphat, (z if return_z else None)
