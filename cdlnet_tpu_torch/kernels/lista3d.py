"""The fused 3D (video) LISTA forward on hand-written CUDA kernels
(counterpart of cdlnet_tpu/kernels/lista3d.py).

The K-iteration loop runs in the stride-phase (space-to-depth) layout:
y2 = space_to_depth(yp) has Cp = C*s^3 channels on the (Dc, Hc, Wc) code
grid, and both strided convolutions become stride-1 correlations over
Qd x Qh x Qw phase taps. Each iteration is two kernel launches:

  lista3d_syn_residual   r = [mask *] (B_k^T z) [- y2]
  lista3d_ana_threshold  z = ST(z - A_k r, tau_k)

k = 0 is the analysis with r = -y2 and z = 0, and the final x2 = B_0^T z is
the synthesis without mask and y2: 2K launches per clip. The code tensor z
stays in device memory between launches (at the flagship shape it is
~22 MB, which the 50 MB L2 mostly holds). Tensors are (N, ch, Dc, Hc, Wc),
contiguous, fp32.

For training the loop also keeps every z_k and r_k (the histories the
reverse pass reads), in the dtype hist_dtype() names: bf16 by default, as
in the JAX package, fp32 with CDLNET_HIST_DTYPE=f32. In bf16 the iteration
still runs in fp32: z and r are fp32 carries, and each writer kernel stores
its output's bf16 copy (round to nearest even) into the history slice in
the same epilogue (the `hist` operand of the pair), so the forward's output
and loss are bitwise the fp32 mode's; the reverse kernels read the bf16
histories as they are (kernels/lista3d_bwd.py).

Each wrapper runs its CUDA kernel on CUDA tensors, or raises; it runs the
plain PyTorch version beside it (the same function on F.conv3d over the
phase channels) only for CPU tensors. `launches` counts kernel launches,
those of the reverse kernels (kernels/lista3d_bwd.py) and of the 2D pair
(kernels/lista2d.py) too.
"""

from __future__ import annotations

import collections
import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from cdlnet_tpu_torch.core.ops import ST
from cdlnet_tpu_torch.ops import polyphase as pp
from cdlnet_tpu_torch.utils import trace_span

# kernel launches per wrapper name; plain (CPU) calls do not count
launches: collections.Counter = collections.Counter()
# of those, the launches of the bf16-history instantiations (a writer with a
# `hist` slice, a reader on a bf16 history), per wrapper name
hist_launches: collections.Counter = collections.Counter()


def hist_dtype() -> torch.dtype:
    """The dtype of the training histories, z_k and r_k, that the fused 3D
    and 2D soft-threshold loops store for their reverse passes (counterpart
    of cdlnet_tpu/kernels/lista2d.py::hist_dtype, which is also
    kernels/lista2d.py's and autodiff.hist3d_dtype here): torch.bfloat16
    unless CDLNET_HIST_DTYPE (or its alias CDLNET_LISTA3D_HIST_DTYPE) is
    "f32", "fp32" or "float32", then torch.float32. Read at every call.

    bf16 halves the train step's largest memory term (the flagship video
    step's 1.39 GB of fp32 histories) at a small relative gradient
    deviation; fp32 gives gradients to fp32 reassociation. Either way the
    iteration runs in fp32 and only the stored copies round (the JAX
    package's resident 3D and 2D contract), on every clip and image size:
    the JAX package's pair route, whose carry rounds too, has no
    counterpart. The CSR models' training (autodiff.csr_fused_2d_train)
    stores its z, r and u histories at this dtype too."""
    env = (os.environ.get("CDLNET_HIST_DTYPE")
           or os.environ.get("CDLNET_LISTA3D_HIST_DTYPE", "bf16"))
    return torch.float32 if env in ("f32", "fp32", "float32") else torch.bfloat16


@dataclass(frozen=True)
class Geom:
    """Phase-domain geometry of the stride-s conv with kernel P = (kD, kH,
    kW) (3D) or (kH, kW) (2D) and padding pads: per dim, taps q in [q_lo,
    q_hi]."""

    s: int
    P: tuple
    pads: tuple

    @property
    def taps(self):
        return [pp._tap_ranges(P, p, self.s) for P, p in zip(self.P, self.pads)]

    @property
    def off_a(self):
        """Analysis tap offsets: input index = output index + q + q_lo."""
        return tuple(lo for lo, _ in self.taps)

    @property
    def off_s(self):
        """Synthesis (flipped-tap) offsets: -(Q-1) - q_lo == -q_hi."""
        return tuple(-hi for _, hi in self.taps)


def prep_A2m_3d(A: torch.Tensor, s: int, pads) -> torch.Tensor:
    """Phase-domain analysis banks in kernel layout (K, Cp, Qd, Qh, Qw, M):
    input channel, taps, then the output code channel, contiguous."""
    A2, _, _, _ = pp.polyphase_weights(A, s, pads, 3)  # (K, M, Cp, Qd, Qh, Qw)
    return A2.permute(0, 2, 3, 4, 5, 1).contiguous()


def prep_B2m_3d(B: torch.Tensor, s: int, pads) -> torch.Tensor:
    """Phase-domain synthesis banks in kernel layout (K, M, Qd, Qh, Qw, Cp),
    taps flipped, so the synthesis is a correlation like the analysis."""
    _, B2t, _, _ = pp.polyphase_weights(B, s, pads, 3)  # (K, M, Cp, Qd, Qh, Qw)
    return B2t.permute(0, 1, 3, 4, 5, 2).contiguous()


def _correlate_plain(x, wt, off):
    """out[n,o,p] = sum_{i,q} wt[i,q,o] * x[n,i,p+q+off], zero outside x.
    wt: (I, Qd, Qh, Qw, O); off: per-dim (D, H, W) tap offsets."""
    Q = wt.shape[1:4]
    pad = []
    for q, o in zip(reversed(Q), reversed(off)):  # F.pad order: W, H, D
        pad += [-o, q - 1 + o]
    return F.conv3d(F.pad(x, pad), wt.permute(4, 0, 1, 2, 3))


def lista3d_ana_threshold_plain(r, z, wa, tau, geom):
    """Plain version of lista3d_ana_threshold."""
    u = _correlate_plain(r, wa, geom.off_a)
    v = -u if z is None else z - u
    return ST(v, tau[:, :, None, None, None])


def lista3d_syn_residual_plain(z, ws, geom, mask=None, y=None):
    """Plain version of lista3d_syn_residual."""
    r = _correlate_plain(z, ws, geom.off_s)
    if mask is not None:
        r = mask * r
    return r if y is None else r - y


FP32, BF16 = (torch.float32,), (torch.bfloat16,)
HISTORY = (torch.float32, torch.bfloat16)  # a history operand the reverse kernels read


def _check(name, t, shape, dtypes=FP32):
    if t.device.type != "cuda" or t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(
            f"{name}: the CUDA kernel takes a contiguous "
            f"{' or '.join(str(d) for d in dtypes)} CUDA tensor here, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _out(out, shape, like):
    """The kernel's output: `out` after checking it, else a new tensor."""
    if out is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    _check("out", out, shape)
    return out


def _into(out, result, hist=None):
    """The plain version's result, copied into `out` if given, and its
    copy in the history's dtype into `hist` if given (round to nearest even
    for bf16, as the kernels' epilogues)."""
    result = result if out is None else out.copy_(result)
    if hist is not None:
        hist.copy_(result)
    return result


def _hist(hist, shape):
    """The pointer of a writer's bf16 history slice (checked), or None."""
    if hist is None:
        return None
    _check("hist", hist, shape, BF16)
    return hist.data_ptr()


# cudaErrorInvalidConfiguration: what a C entry returns, before launching,
# for a call whose stage exceeds a block's shared memory
INVALID_CONFIGURATION = 9


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {err})")


def lista3d_ana_threshold(r, z, wa, tau, geom, out=None, hist=None):
    """z_new = ST(z - A_k r, tau): the analysis + soft threshold.

    r: (N, Cp, Dc, Hc, Wc) residual; z: (N, M, Dc, Hc, Wc) codes, or None
    for zeros (k = 0); wa: (Cp, Qd, Qh, Qw, M) from prep_A2m_3d; tau: (N, M);
    geom: the Geom of the banks; out: a contiguous (N, M, Dc, Hc, Wc) tensor
    to write the codes into (it may be z: each code is read, then written,
    by one thread), or None for a new one; hist: a contiguous bf16 (N, M,
    Dc, Hc, Wc) tensor (a history slice) that also takes the codes, rounded
    to nearest even, or None. Returns the new code tensor.
    """
    if r.device.type == "cpu":
        return _into(out, lista3d_ana_threshold_plain(r, z, wa, tau, geom), hist)
    from cdlnet_tpu_torch.kernels._build import library

    lib = library()
    N, Cp, D, H, W = r.shape
    M = wa.shape[-1]
    Qd, Qh, Qw = wa.shape[1:4]
    _check("r", r, r.shape)
    _check("wa", wa, (Cp, Qd, Qh, Qw, M))
    _check("tau", tau, (N, M))
    if z is not None:
        _check("z", z, (N, M, D, H, W))
    out = _out(out, (N, M, D, H, W), r)
    err = lib.lista3d_ana_threshold(
        _ptr(r), _ptr(wa), _ptr(z), _ptr(tau), _ptr(out), _hist(hist, out.shape),
        N, Cp, M, D, H, W, Qd, Qh, Qw, *geom.off_a, geom.s, *geom.P, *geom.pads,
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    _raise_on(err, "lista3d_ana_threshold")
    launches["lista3d_ana_threshold"] += 1
    hist_launches["lista3d_ana_threshold"] += hist is not None
    return out


def lista3d_syn_residual(z, ws, geom, mask=None, y=None, out=None, hist=None):
    """r = [mask *] (B_k^T z) [- y]: the synthesis (+ residual).

    z: (N, M, Dc, Hc, Wc); ws: (M, Qd, Qh, Qw, Cp) from prep_B2m_3d; geom:
    the Geom of the banks; mask, y: (N, Cp, Dc, Hc, Wc) or None; out: a
    contiguous (N, Cp, Dc, Hc, Wc) tensor that is not z, or None; hist: as
    in lista3d_ana_threshold, for r. Returns (N, Cp, Dc, Hc, Wc).
    """
    if z.device.type == "cpu":
        return _into(out, lista3d_syn_residual_plain(z, ws, geom, mask=mask, y=y), hist)
    return _syn_residual(z, ws, geom.off_s, mask, y, out, hist)


def _syn_residual(z, ws, off, mask, y, out, hist=None):
    """lista3d_syn_residual's launch at tap offsets `off`. A bank whose
    stage does not fit a block's shared memory (the kernel returns
    cudaErrorInvalidConfiguration: the stride-1 3D banks, P = (7, 7, 5)'s
    245 taps) runs as two launches over halves of its depth taps (each split
    again if need be), summed, with the mask and y applied after (and the
    history's copy taken from the sum)."""
    from cdlnet_tpu_torch.kernels._build import library

    lib = library()
    N, M, D, H, W = z.shape
    Cp = ws.shape[-1]
    Qd, Qh, Qw = ws.shape[1:4]
    _check("z", z, z.shape)
    _check("ws", ws, (M, Qd, Qh, Qw, Cp))
    for name, t in (("mask", mask), ("y", y)):
        if t is not None:
            _check(name, t, (N, Cp, D, H, W))
    out = _out(out, (N, Cp, D, H, W), z)
    err = lib.lista3d_syn_residual(
        _ptr(z), _ptr(ws), _ptr(mask), _ptr(y), _ptr(out), _hist(hist, out.shape),
        N, M, Cp, D, H, W, Qd, Qh, Qw, *off,
        torch.cuda.current_stream(z.device).cuda_stream,
    )
    if err == INVALID_CONFIGURATION and Qd > 1:
        h = (Qd + 1) // 2
        lo = _syn_residual(z, ws[:, :h].contiguous(), off, None, None, None)
        hi = _syn_residual(z, ws[:, h:].contiguous(), (off[0] + h, *off[1:]), None, None, None)
        r = lo.add_(hi)
        if mask is not None:
            r.mul_(mask)
        if y is not None:
            r.sub_(y)
        return _into(out, r, hist)
    _raise_on(err, "lista3d_syn_residual")
    launches["lista3d_syn_residual"] += 1
    hist_launches["lista3d_syn_residual"] += hist is not None
    return out


def per_sample(c, N, like) -> torch.Tensor:
    """c (a number, or one value per sample) as N values on `like`'s device
    and dtype; a number is filled on the device, not copied from the host,
    so a captured CUDA graph can hold the call."""
    if isinstance(c, (int, float)):
        c_arr = torch.full((1,), float(c), dtype=like.dtype, device=like.device)
    else:
        c_arr = torch.as_tensor(c, dtype=like.dtype, device=like.device).reshape(-1)
    return c_arr.expand(N)


def phase_operands(yp, A, B, t, c, stride, mask=None):
    """The fused loop's operands in the phase domain: (y2, m2, wa, ws, tau,
    geom) with y2 = space_to_depth(yp), m2 the mask's (or None), the banks
    wa = prep_A2m_3d(A) (K, Cp, Qd, Qh, Qw, M) and ws = prep_B2m_3d(B)
    (K, M, Qd, Qh, Qw, Cp), and tau[k, n] = t[k,0] + c[n] * t[k,1] (K, N, M).
    Differentiable in A, B and t (gathers, flips and products)."""
    with trace_span("lista3d_operands"):
        N, C, D, H, W = yp.shape
        P = A.shape[-3:]
        s = stride
        if D % s or H % s or W % s:
            raise ValueError(f"clip {(D, H, W)} is not divisible by stride {s}")
        pads = tuple(p // 2 for p in P)
        geom = Geom(s, tuple(P), pads)
        wa = prep_A2m_3d(A, s, pads)
        ws = prep_B2m_3d(B, s, pads)
        y2 = pp.space_to_depth(yp, s, 3).contiguous()  # (N, Cp, Dc, Hc, Wc)
        m2 = (
            pp.space_to_depth(mask.expand(yp.shape), s, 3).contiguous()
            if mask is not None
            else None
        )
        c_arr = per_sample(c, N, yp)
        # tau[k] = t[k,0] + c * t[k,1] per sample: (K, N, M)
        tau = (t[None, :, 0, :, 0, 0, 0] + c_arr[:, None, None] * t[None, :, 1, :, 0, 0, 0])
        tau = tau.transpose(0, 1).contiguous()
        return y2, m2, wa, ws, tau, geom


def lista3d_loop(y2, m2, wa, ws, tau, geom, return_hists=False, hists_dtype=None):
    """The 2K kernel launches of the fused loop on phase-domain operands
    (phase_operands). Returns (x2, z, hists): x2 = B_0^T z (N, Cp, Dc, Hc,
    Wc), z the final codes, and with return_hists the histories (z_hist (K,
    N, M, Dc, Hc, Wc) of every z_k, r_hist (K-1, N, Cp, Dc, Hc, Wc) of
    every residual r_k) that the reverse pass reads, else None.

    hists_dtype: the histories' dtype, None for hist_dtype(). fp32: the
    kernels write each z_k and r_k into its slice. bf16: they write the
    fp32 carries z and r (updated in place) and, in the same launch, the
    rounded copy into the slice; the outputs are bitwise the fp32 mode's."""
    with trace_span("lista3d_loop"):
        K, M = wa.shape[0], wa.shape[-1]
        z_hist = r_hist = zc = rc = None
        if return_hists:
            dtype = hist_dtype() if hists_dtype is None else hists_dtype
            N, _, D, H, W = y2.shape
            z_hist = y2.new_empty((K, N, M, D, H, W), dtype=dtype)
            r_hist = y2.new_empty((K - 1, *y2.shape), dtype=dtype)
        # fp32 histories: each launch writes its slice, which the next one
        # reads; bf16: the carries zc and rc, updated in place, and each
        # launch's rounded copy in its slice; none: a new tensor a launch
        slices = z_hist is not None and z_hist.dtype == torch.float32
        bf16 = z_hist is not None and not slices
        if bf16:
            zc, rc = y2.new_empty(z_hist.shape[1:]), torch.empty_like(y2)
        zh = lambda k: z_hist[k] if bf16 else None
        rh = lambda k: r_hist[k] if bf16 else None
        z = lista3d_ana_threshold(-y2, None, wa[0], tau[0], geom,
                                  out=z_hist[0] if slices else zc, hist=zh(0))
        for k in range(1, K):
            r = lista3d_syn_residual(z, ws[k], geom, mask=m2, y=y2,
                                     out=r_hist[k - 1] if slices else rc, hist=rh(k - 1))
            z = lista3d_ana_threshold(r, z, wa[k], tau[k], geom,
                                      out=z_hist[k] if slices else zc, hist=zh(k))
        x2 = lista3d_syn_residual(z, ws[0], geom)
        return x2, z, (None if z_hist is None else (z_hist, r_hist))


def lista3d_fused(yp, A, B, t, c, stride=1, mask=None, return_z=True,
                  return_hists=False, hists_dtype=None):
    """Fused 3D LISTA + final dictionary synthesis.

    yp: (N, C, D, H, W) pre-processed clip batch (D, H, W divisible by
    stride); A, B: (K, M, C, Pd, Ph, Pw); t: (K, 2, M, 1, 1, 1); c: scalar
    or (N, 1, 1, 1, 1). Returns (xphat (N, C, D, H, W), z (N, M, Dc, Hc, Wc)
    or None) — ops.lista.lista_3d + conv_transpose3d(B[0]) to fp32
    reassociation tolerance — and with return_hists a third item, the
    histories (z_hist, r_hist) of lista3d_loop, at hists_dtype (None:
    hist_dtype()). No gradient flows through the kernels here: training
    goes through autodiff.lista3d_fused_diff.
    """
    y2, m2, wa, ws, tau, geom = phase_operands(yp, A, B, t, c, stride, mask)
    x2, z, hists = lista3d_loop(y2, m2, wa, ws, tau, geom, return_hists, hists_dtype)
    xphat = pp.depth_to_space(x2, stride, 3, yp.shape[1])
    if return_hists:
        return xphat, (z if return_z else None), hists
    return xphat, (z if return_z else None)
