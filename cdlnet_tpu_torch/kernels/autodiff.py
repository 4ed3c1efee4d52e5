"""The differentiable fused 2D and 3D LISTA (counterpart of
cdlnet_tpu/kernels/autodiff.py's lista2d_fused_diff / lista2d_tiled_diff,
lista3d_fused_diff and csr_fused_2d_train).

lista2d_fused_diff and lista3d_fused_diff run the kernel forward with its
histories at hist_dtype() (bf16 unless CDLNET_HIST_DTYPE=f32, read at
every forward: the JAX package's default; hist3d_dtype is its 3D alias
there and here) and the reverse loop of kernels/lista2d_bwd.py or
kernels/lista3d_bwd.py as its backward, through one
torch.autograd.Function on phase-domain operands: the Function returns the
gradients of the phase banks and of the per-sample thresholds, and torch
autograd carries them back to A, B and t through the differentiable weight
prep (prep_A2m_* / prep_B2m_*, gathers and flips whose valid mask gives the
structurally zero phase taps a zero gradient) and tau = t0 + c t1, as JAX's
vjp of the prep does. GDLNet's Gabor parameters get theirs the same way,
through get_filters(). The 2D path is one path for every crop size: the
JAX package's routing between its whole-image and banded reverse kernels
by VMEM budget has no counterpart.

The cotangents of the input, sigma and mask are zero by construction:
training differentiates with respect to the parameters only. For input
gradients (saliency, input optimization) use backend "xla".

The frame-recurrent CSR models train through csr_fused_2d_train, a
Function of its own: it returns the code z beside x, and its gradients
reach the carried neighbour codes and the gamma banks too (below). Its z,
r and u histories follow hist_dtype() too, read at every forward, as the
JAX package's csr_fused_2d_train stores them.

On CPU tensors the same Functions run the kernels' plain versions, so the
reverse loop is the port's own on either device, never torch autograd
through the forward.
"""

from __future__ import annotations

import torch

from cdlnet_tpu_torch.kernels import lista2d, lista3d
from cdlnet_tpu_torch.kernels.lista2d_bwd import lista2d_fused_bwd
from cdlnet_tpu_torch.kernels.lista3d import hist_dtype
from cdlnet_tpu_torch.kernels.lista3d_bwd import lista3d_fused_bwd
from cdlnet_tpu_torch.ops import polyphase as pp

# the 3D training histories' dtype (cdlnet_tpu/kernels/autodiff.py::
# hist3d_dtype): the same setting as the 2D one
hist3d_dtype = hist_dtype

RETURN_Z_HINT = (
    "backend 'pallas'/'cuda' forward with return_z=True under autograd runs "
    "the inference-grade fused kernel, which has no gradient. To "
    "differentiate, call forward(..., return_z=False) (what train.fit "
    "does), run under torch.no_grad(), or use backend='xla'."
)

# spatial dims -> (phase operands, forward loop, reverse loop)
_PATHS = {
    2: (lista2d.phase_operands, lista2d.lista2d_loop, lista2d_fused_bwd),
    3: (lista3d.phase_operands, lista3d.lista3d_loop, lista3d_fused_bwd),
}


class _ListaFused(torch.autograd.Function):
    """x2 = the fused loop on (y2, m2, wa, ws, tau); backward: the reverse
    loop over the histories the forward stored, in the dtype they were
    stored in (hist_dtype() at the forward)."""

    @staticmethod
    def forward(ctx, y2, m2, wa, ws, tau, geom, dims):
        _, loop, _ = _PATHS[dims]
        x2, _, (z_hist, r_hist) = loop(y2, m2, wa, ws, tau, geom, return_hists=True)
        ctx.geom, ctx.dims = geom, dims
        ctx.save_for_backward(y2, m2, wa, ws, tau, z_hist, r_hist)
        return x2

    @staticmethod
    def backward(ctx, dx2):
        y2, m2, wa, ws, tau, z_hist, r_hist = ctx.saved_tensors
        _, _, reverse = _PATHS[ctx.dims]
        dwa, dws, dtau = reverse(dx2.contiguous(), y2, m2, (wa, ws), tau,
                                 z_hist, r_hist, ctx.geom)
        return None, None, dwa, dws, dtau, None, None


def _fused_diff(dims, yp, A, B, t, c, stride, mask):
    detach = lambda v: v.detach() if isinstance(v, torch.Tensor) else v
    operands, _, _ = _PATHS[dims]
    y2, m2, wa, ws, tau, geom = operands(detach(yp), A, B, t, detach(c), stride,
                                         detach(mask))
    x2 = _ListaFused.apply(y2, m2, wa, ws, tau, geom, dims)
    return pp.depth_to_space(x2, stride, dims, yp.shape[1])


def lista2d_fused_diff(yp, A, B, t, c, stride=1, mask=None):
    """Differentiable fused 2D LISTA + final synthesis. Returns xphat
    (N, C, H, W), as lista2d.lista2d_fused; gradients reach A, B and t
    only."""
    return _fused_diff(2, yp, A, B, t, c, stride, mask)


def lista3d_fused_diff(yp, A, B, t, c, stride=1, mask=None):
    """Differentiable fused 3D LISTA + final synthesis. Returns xphat
    (N, C, D, H, W), as lista3d.lista3d_fused; gradients reach A, B and t
    only."""
    return _fused_diff(3, yp, A, B, t, c, stride, mask)


class _CsrFused(torch.autograd.Function):
    """(x2, z) = the fused loop in a CSR prox mode (or the soft threshold
    with no codes) on (y2, m2, wa, ws, tau) with the gamma banks and
    neighbour codes; backward: the reverse loop over the z, r and u
    histories (at hist_dtype() of the forward), seeded by the cotangent of
    the returned z."""

    @staticmethod
    def forward(ctx, geom, y2, m2, wa, ws, tau, gam1, gam2, zp, za):
        gams = tuple(b for b in (gam1, gam2) if b is not None)
        codes = tuple(z for z in (zp, za) if z is not None)
        # histories at hist_dtype() in every mode, the first frame's soft
        # threshold too; a remat rerun reads the same setting
        x2, z, hists = lista2d.lista2d_loop(y2, m2, wa, ws, tau, geom, return_hists=True,
                                            gams=gams, codes=codes)
        z_hist, r_hist, u_hist = (*hists, None)[:3]
        ctx.geom = geom
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(y2, m2, wa, ws, tau, z_hist, r_hist, u_hist, gam1, gam2,
                              zp, za)
        return x2, z

    @staticmethod
    def backward(ctx, dx2, dz):
        y2, m2, wa, ws, tau, z_hist, r_hist, u_hist, gam1, gam2, zp, za = ctx.saved_tensors
        gams = tuple(b for b in (gam1, gam2) if b is not None)
        codes = tuple(z for z in (zp, za) if z is not None)
        dx2 = torch.zeros_like(y2) if dx2 is None else dx2.contiguous()
        outs = lista2d_fused_bwd(dx2, y2, m2, (wa, ws), tau, z_hist, r_hist, ctx.geom,
                                 gams=gams, codes=codes, u_hist=u_hist,
                                 dz_out=None if dz is None else dz.contiguous())
        dwa, dws, dtau = outs[:3]
        dgams, dcodes = outs[3:] if codes else ((), ())
        dgam1, dgam2 = (*dgams, None, None)[:2]
        dzp, dza = (*dcodes, None, None)[:2]
        return None, None, None, dwa, dws, dtau, dgam1, dgam2, dzp, dza


def csr_fused_2d_train(yp, A, B, t, c, mask=None, g=None, z_prev=None, g2=None,
                       z_after=None, stride=1):
    """The differentiable fused 2D LISTA of the CSR models' training
    (cdlnet_tpu/kernels/autodiff.py::csr_fused_2d_train). Returns (xphat
    (N, C, H, W), z (N, M, H/s, W/s)) as lista2d.lista2d_fused(...,
    return_z=True) with the same CSR keywords.

    The forward writes the z, r and (in a CSR mode) u histories; the
    backward is lista2d_bwd.lista2d_fused_bwd with the prox's adjoint.
    Gradients reach A, B, t, g, g2 and the carried codes z_prev, z_after,
    and the cotangent of the returned z seeds the reverse, in every mode,
    the soft-threshold one (no codes: a first-frame apply, whose z the next
    apply carries) included. The z_after-only mode runs the one-sided
    kernel with (z_after, g2) in z_prev's slots, as the JAX package does;
    their gradients reach z_after and g2 because the Function takes those
    tensors in those slots. The cotangents of yp, c and mask are zero by
    construction."""
    detach = lambda v: v.detach() if isinstance(v, torch.Tensor) else v
    codes, banks = lista2d.csr_mode(g, z_prev, g2, z_after)
    y2, m2, wa, ws, tau, geom = lista2d.phase_operands(detach(yp), A, B, t, detach(c),
                                                       stride, detach(mask))
    gams = tuple(lista2d.threshold_bank(b, detach(c), yp.shape[0], yp) for b in banks)
    codes = tuple(z.contiguous() for z in codes)
    x2, z = _CsrFused.apply(geom, y2, m2, wa, ws, tau, *(gams + (None,) * (2 - len(gams))),
                            *(codes + (None,) * (2 - len(codes))))
    return pp.depth_to_space(x2, stride, 2, yp.shape[1]), z
