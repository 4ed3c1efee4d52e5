"""Depth-sharded 3D LISTA on the hand-written CUDA kernels (counterpart of
cdlnet_tpu/dist/halo_fused.py).

dist/halo.py proves the sharding math on the plain loop; this module runs
depth sharding on the kernels: each rank runs the UNMODIFIED single-card
kernels of kernels/lista3d.py (the forward pair) and
kernels/lista3d_bwd.py (the reverse set) on a halo-extended window of its
frames, with the halo exchange between kernel launches, point to point
within the depth group. The collectives never enter a kernel.

Exactness: in the stride-phase (code-frame) domain both kernels read depth
taps zero-padded outside their input. One LISTA iteration's reach is
  z_new[d]  <-  z[d - (Qd-1) .. d + (Qd-1)]
(the analysis reads r[d+q_lo .. d+q_hi]; r[d'] reads z[d'-q_hi ..
d'-q_lo]). With hz = Qd-1 frames of true neighbour data on each side of a
rank's kept frames, every kept output's dependency cone holds real data,
and the kernels' zero padding falls either in the extended region whose
outputs are discarded, or at the true clip boundary, where zero padding is
the reference Conv3d's. Edge ranks therefore use ASYMMETRIC windows: the
first rank's window starts at frame 0 and takes 2*hz frames on its right;
interior ranks take hz a side; the last rank mirrors the first. Kept frames
are refreshed (their halos exchanged anew) every iteration, so the
discarded region's errors never propagate.

Training (sharded_fused_3d_train_forward): a torch.autograd.Function
whose forward stores kept-frame histories only (a rank holds 1/n of the
single-card histories), at kernels/lista3d.py::hist_dtype (bf16 by
default, rounded from the fp32 carry, as the JAX package's halo_fused
stores them), and whose backward re-exchanges them (in their dtype) to rebuild
the halos, then runs the port's reverse kernels on the windows: the
synthesis adjoint (lista3d_syn_adjoint), the weight gradient
(lista3d_wgrad) and the synthesis as the analysis adjoint
(lista3d_syn_residual), as kernels/lista3d_bwd.py::fused_bwd does on the
whole clip. Weight gradients take cotangents from kept positions only
(embedded in zero windows), and the depth ranks' partial gradients are
summed by one all-reduce (dist/comm.py::replicate). The input's cotangent
dy is exact (one more analysis-adjoint launch when it is asked for).

The JAX package routes among banded and ring kernels by their VMEM
budgets (_pick_band3, ring_depth_shard_supported, CDLNET_LISTA3D_RING*);
the port has one kernel set for every size, so the gate is the geometry
alone.
"""

from __future__ import annotations

import torch
from torch.autograd import Function

from cdlnet_tpu_torch.dist.comm import (
    fill_window_,
    group_index,
    group_size,
    replicate,
    shard,
    unshard,
    window,
    window_plan,
)
from cdlnet_tpu_torch.dist.halo import batch_rows
from cdlnet_tpu_torch.dist.mesh import as_mesh
from cdlnet_tpu_torch.kernels.lista3d import (
    Geom,
    hist_dtype,
    lista3d_ana_threshold,
    lista3d_syn_residual,
    phase_operands,
)
from cdlnet_tpu_torch.kernels.lista3d_bwd import (
    adjoint_bank,
    lista3d_syn_adjoint,
    lista3d_wgrad,
    phase_rows,
)
from cdlnet_tpu_torch.ops import polyphase as pp


def code_halo(model) -> int:
    """hz = Qd - 1: the depth reach of one LISTA iteration in code frames."""
    lo, hi = Geom(model.s, tuple(model.P), model.pad).taps[0]
    return hi - lo


def fused_depth_shard_supported(model, D, H, W, n_depth, *, train=False, mask=None) -> bool:
    """Gate of the depth-sharded kernel route: a kernel model without
    residual blocks (model.on_kernels), no mask, n_depth >= 2, D divisible
    by n_depth x s, H and W by s, and the kept frames' read cone inside the
    real frames of the windows (hz <= (n_depth - 1) * Dzl; false only for
    tiny clips). The same kernels serve the forward and training (train
    is accepted for the JAX signature). Callers take dist/halo.py when it
    is False."""
    if not getattr(model, "on_kernels", False) or mask is not None:
        return False
    s = model.s
    if n_depth < 2 or D % (n_depth * s) or H % s or W % s:
        return False
    return code_halo(model) <= (n_depth - 1) * (D // s // n_depth)


class _Windows:
    """A rank's window of Dce = Dzl + 2 hz code frames around its Dzl kept
    frames (dim 2 of (N, ch, D, H, W) tensors): `lo` halo frames below the
    kept ones (0 on the first rank, 2 hz on the last, hz between; a single
    rank's window is its frames)."""

    def __init__(self, group, Dzl, hz):
        n, me = group_size(group), group_index(group)
        if n == 1:  # one rank holds the clip: its window is the clip
            hz = 0
        lo = lambda r: 0 if r == 0 else (2 * hz if r == n - 1 else hz)
        self.Dzl, self.Dce, self.lo, self.group = Dzl, Dzl + 2 * hz, lo(me), group
        windows = [(r * Dzl - lo(r), r * Dzl - lo(r) + self.Dce) for r in range(n)]
        self.plan = window_plan(n, Dzl, windows, me)

    def ext(self, kept):
        """A new window around the kept frames (neighbours' frames in the
        halos, zeros past the clip)."""
        return window(kept.contiguous(), self.plan, self.group, 2, self.Dce)

    def refresh(self, win):
        """In place: the window's halos from the neighbours' kept frames."""
        return fill_window_(win, win.narrow(2, self.lo, self.Dzl), self.plan, self.group, 2)

    def crop(self, win):
        return win.narrow(2, self.lo, self.Dzl).contiguous()

    def embed(self, kept):
        """A window holding the kept frames and zeros elsewhere."""
        shape = list(kept.shape)
        shape[2] = self.Dce
        win = kept.new_zeros(shape)
        win.narrow(2, self.lo, self.Dzl).copy_(kept)
        return win


def _forward(win, y2k, wa, ws, tau, geom, hists=False):
    """The 2K launches of the fused loop on this rank's window, the halos
    refreshed before every synthesis. Returns (x2, z) on the kept frames
    and, with hists, the kept histories at hist_dtype() (z_hist (K, N, M,
    Dzl, Hc, Wc), r_hist (K-1, N, Cp, Dzl, Hc, Wc)), copied (and in bf16
    rounded) from the fp32 carries."""
    K = wa.shape[0]
    y2e = win.ext(y2k)
    z = lista3d_ana_threshold(-y2e, None, wa[0], tau[0], geom)
    z_hist = r_hist = None
    if hists:
        N, _, Dzl, Hc, Wc = y2k.shape
        dtype = hist_dtype()
        z_hist = y2k.new_empty((K, N, wa.shape[-1], Dzl, Hc, Wc), dtype=dtype)
        r_hist = y2k.new_empty((K - 1, *y2k.shape), dtype=dtype)
        z_hist[0].copy_(z.narrow(2, win.lo, win.Dzl))
    for k in range(1, K):
        win.refresh(z)
        r = lista3d_syn_residual(z, ws[k], geom, y=y2e)
        z = lista3d_ana_threshold(r, z, wa[k], tau[k], geom)
        if hists:
            r_hist[k - 1].copy_(r.narrow(2, win.lo, win.Dzl))
            z_hist[k].copy_(z.narrow(2, win.lo, win.Dzl))
    win.refresh(z)
    x2 = lista3d_syn_residual(z, ws[0], geom)
    return win.crop(x2), win.crop(z), (z_hist, r_hist)


class _DepthShardedFused(Function):
    """x2 (kept frames) = the windowed kernel loop on (y2, wa, ws, tau);
    backward: the windowed reverse loop over the kept histories."""

    @staticmethod
    def forward(ctx, y2k, wa, ws, tau, geom, win):
        x2k, _, (z_hist, r_hist) = _forward(win, y2k, wa, ws, tau, geom, hists=True)
        ctx.geom, ctx.win = geom, win
        ctx.save_for_backward(y2k, wa, ws, tau, z_hist, r_hist)
        return x2k

    @staticmethod
    def backward(ctx, dx2k):
        y2k, wa, ws, tau, z_hist, r_hist = ctx.saved_tensors
        geom, win = ctx.geom, ctx.win
        dx2k = dx2k.contiguous()
        K = wa.shape[0]
        taps = tuple(wa.shape[2:5])
        wa_adj = adjoint_bank(wa)  # A_k* as a synthesis bank
        ws_adj = adjoint_bank(ws)  # B_k* as an analysis bank
        rows = phase_rows(geom, wa.shape[1], 3)
        dwa, dws, dtau = torch.empty_like(wa), torch.empty_like(ws), torch.empty_like(tau)
        want_dy = ctx.needs_input_grad[0]
        dy = torch.zeros_like(y2k) if want_dy else None

        def syn_wgrad(z_kept, g_kept, alpha):
            """The synthesis bank's gradient from the kept cotangent g and
            the codes around it."""
            dw = lista3d_wgrad(win.embed(g_kept), win.ext(z_kept), taps, geom.off_a,
                               alpha=alpha, rows=rows)
            return adjoint_bank(dw)

        # dv is a window, zero outside the kept frames (its codes are
        # embedded there), so its dtau sums kept positions only
        dv, dtau[K - 1] = lista3d_syn_adjoint(win.ext(dx2k), ws_adj[0],
                                              win.embed(z_hist[K - 1]), geom)
        dws[0] = syn_wgrad(z_hist[K - 1], dx2k, 1.0)
        for k in range(K - 1, 0, -1):
            dwa[k] = lista3d_wgrad(win.ext(r_hist[k - 1]), dv, taps, geom.off_a,
                                   alpha=-1.0, rows=rows)
            g = win.crop(lista3d_syn_residual(win.refresh(dv.clone()), wa_adj[k], geom))
            dws[k] = syn_wgrad(z_hist[k - 1], g, -1.0)
            if want_dy:
                dy += g
            dv, dtau[k - 1] = lista3d_syn_adjoint(win.ext(g), ws_adj[k],
                                                  win.embed(z_hist[k - 1]), geom,
                                                  base=dv, alpha=-1.0)
        dwa[0] = lista3d_wgrad(win.ext(y2k), dv, taps, geom.off_a, rows=rows)
        if want_dy:
            dy += win.crop(lista3d_syn_residual(win.refresh(dv.clone()), wa_adj[0], geom))
        return dy, dwa, dws, dtau, None, None


def _local_operands(model, ypc, sigma, mesh, depth_axis, batch_axis):
    """This rank's phase-domain operands and window: (y2, wa, ws, tau,
    geom, window, depth group, batch group), the parameters replicated
    over both groups."""
    from cdlnet_tpu_torch.models.base import sigma_scale

    mesh = as_mesh(mesh)
    s = model.s
    nD = mesh.size(depth_axis)
    N, C, D, H, W = ypc.shape
    if D % (nD * s):
        raise ValueError(f"depth {D} must divide depth axis {nD} x stride {s}")
    if H % s or W % s:
        raise ValueError("H, W must be divisible by the stride (pre-pad upstream)")
    gd, gb = mesh.group(depth_axis), mesh.group(batch_axis)
    p = replicate({"A": model.A, "B": model.B, "t": model.t}, (gd, gb))
    c = sigma_scale(sigma, model.adaptive, 5)
    if isinstance(c, torch.Tensor):
        c = batch_rows(c.to(ypc.device, ypc.dtype), gb, N)
    yl = shard(shard(ypc, gb, 0), gd, 2)
    y2, _, wa, ws, tau, geom = phase_operands(yl, p["A"], p["B"], p["t"], c, s)
    return y2, wa, ws, tau, geom, _Windows(gd, y2.shape[2], code_halo(model)), gd, gb


def sharded_lista_3d_fused_forward(model, ypc, sigma=None, *, mesh, depth_axis: str = "depth",
                                   batch_axis: str | None = None, return_z: bool = False):
    """Depth-sharded CDLNetVideo forward on the kernels (no gradient).

    ypc: the whole pre-processed (N, C, D, H, W) batch on every rank
    (mean-subtracted, H/W stride-divisible: core.preprocess.pre_process_3d
    upstream, as fit and serve do), D % (n_depth * s) == 0. Frames shard
    over depth_axis, and rows over batch_axis when given. Returns (xp, z or
    None), whole on every rank: the unsharded kernel forward's outputs
    (the module docstring's exactness argument)."""
    with torch.no_grad():
        y2, wa, ws, tau, geom, win, gd, gb = _local_operands(
            model, ypc, sigma, mesh, depth_axis, batch_axis)
        x2k, zk, _ = _forward(win, y2, wa, ws, tau, geom)
        xp = pp.depth_to_space(x2k, model.s, 3, ypc.shape[1])
        xp = unshard(unshard(xp, gd, 2), gb, 0)
        z = unshard(unshard(zk, gd, 2), gb, 0) if return_z else None
    return xp, z


def sharded_fused_3d_train_forward(model, ypc, sigma, *, mesh, depth_axis: str = "depth",
                                   batch_axis: str | None = None):
    """Differentiable depth-sharded forward on the kernels: xp for the
    pre-processed ypc (as sharded_lista_3d_fused_forward; run
    core.preprocess.post_process_3d on the result), whole on every rank.
    Gradients reach model.A, model.B and model.t (the unsharded
    gradients, on every rank) and ypc when it requires them."""
    y2, wa, ws, tau, geom, win, gd, gb = _local_operands(
        model, ypc, sigma, mesh, depth_axis, batch_axis)
    x2k = _DepthShardedFused.apply(y2, wa, ws, tau, geom, win)
    xp = pp.depth_to_space(x2k, model.s, 3, ypc.shape[1])
    return unshard(unshard(xp, gd, 2), gb, 0)


def depth_sharded_forward(model, y, sigma=None, *, mesh, depth_axis: str = "depth",
                          batch_axis: str | None = None):
    """A CDLNetVideo's xhat for the whole clip batch y (N, C, D, H, W) on
    every rank, the frames sharded over depth_axis (D divisible by its size
    x s) and the rows over batch_axis: pre-process, then the kernel route
    where fused_depth_shard_supported holds (the differentiable one when
    gradients are enabled), else the plain halo route (dist/halo.py:
    residual blocks, backend "xla"), then post-process. fit and Denoiser
    take it under a depth mesh."""
    from cdlnet_tpu_torch.core.pad import unpad_3d
    from cdlnet_tpu_torch.core.preprocess import post_process_3d, pre_process_3d
    from cdlnet_tpu_torch.dist.halo import sharded_lista_3d_forward

    mesh = as_mesh(mesh)
    ypc, prm, _ = pre_process_3d(y, model.s)
    kw = dict(mesh=mesh, depth_axis=depth_axis, batch_axis=batch_axis)
    if fused_depth_shard_supported(model, *ypc.shape[2:], mesh.size(depth_axis)):
        if torch.is_grad_enabled():
            xp = sharded_fused_3d_train_forward(model, ypc, sigma, **kw)
        else:
            xp, _ = sharded_lista_3d_fused_forward(model, ypc, sigma, **kw)
        return post_process_3d(xp, prm)
    # the plain halo route computes the clip mean itself: it takes the
    # padded clip before centring, as the JAX package's does
    xhat, _ = sharded_lista_3d_forward(model, ypc + prm[0], sigma, return_z=False, **kw)
    return unpad_3d(xhat, prm[1])
