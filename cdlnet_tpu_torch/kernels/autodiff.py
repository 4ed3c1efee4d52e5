"""The differentiable fused 3D LISTA (counterpart of the 3D half of
cdlnet_tpu/kernels/autodiff.py).

lista3d_fused_diff runs the kernel forward with fp32 histories and the
reverse loop of kernels/lista3d_bwd.py as its backward, through one
torch.autograd.Function on phase-domain operands: the Function returns the
gradients of the phase banks and of the per-sample thresholds, and torch
autograd carries them back to A, B and t through the differentiable weight
prep (lista3d.prep_A2m_3d / prep_B2m_3d, gathers and flips whose valid mask
gives the structurally zero phase taps a zero gradient) and tau = t0 + c t1,
as JAX's vjp of the prep does.

The cotangents of the input, sigma and mask are zero by construction:
training differentiates with respect to the parameters only. For input
gradients (saliency, input optimization) use backend "xla".

On CPU tensors the same Function runs the kernels' plain versions, so the
reverse loop is the port's own on either device, never torch autograd
through the forward.
"""

from __future__ import annotations

import torch

from cdlnet_tpu_torch.kernels.lista3d import lista3d_loop, phase_operands
from cdlnet_tpu_torch.kernels.lista3d_bwd import lista3d_fused_bwd
from cdlnet_tpu_torch.ops import polyphase as pp

RETURN_Z_HINT = (
    "backend 'pallas'/'cuda' forward with return_z=True under autograd runs "
    "the inference-grade fused kernel, which has no gradient. To "
    "differentiate, call forward(..., return_z=False) (what train.fit "
    "does), run under torch.no_grad(), or use backend='xla'."
)


class _Lista3dFused(torch.autograd.Function):
    """x2 = the fused loop on (y2, m2, wa, ws, tau); backward: the reverse
    loop over the histories the forward stored."""

    @staticmethod
    def forward(ctx, y2, m2, wa, ws, tau, geom):
        x2, _, (z_hist, r_hist) = lista3d_loop(y2, m2, wa, ws, tau, geom,
                                               return_hists=True)
        ctx.geom = geom
        ctx.save_for_backward(y2, m2, wa, ws, tau, z_hist, r_hist)
        return x2

    @staticmethod
    def backward(ctx, dx2):
        y2, m2, wa, ws, tau, z_hist, r_hist = ctx.saved_tensors
        dwa, dws, dtau = lista3d_fused_bwd(dx2.contiguous(), y2, m2, (wa, ws),
                                           tau, z_hist, r_hist, ctx.geom)
        return None, None, dwa, dws, dtau, None


def lista3d_fused_diff(yp, A, B, t, c, stride=1, mask=None):
    """Differentiable fused 3D LISTA + final synthesis. Returns xphat
    (N, C, D, H, W), as lista3d.lista3d_fused; gradients reach A, B and t
    only."""
    detach = lambda v: v.detach() if isinstance(v, torch.Tensor) else v
    y2, m2, wa, ws, tau, geom = phase_operands(detach(yp), A, B, t, detach(c),
                                               stride, detach(mask))
    x2 = _Lista3dFused.apply(y2, m2, wa, ws, tau, geom)
    return pp.depth_to_space(x2, stride, 3, yp.shape[1])
