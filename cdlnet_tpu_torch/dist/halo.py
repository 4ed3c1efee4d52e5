"""Depth-axis (temporal) sharding of the 3D LISTA forward with halo
exchange, on the plain F.conv3d loop (counterpart of
cdlnet_tpu/dist/halo.py).

Clips are sharded along the frame axis over the mesh's "depth" dim; every
strided Conv3d / ConvTranspose3d takes the boundary frames its kernel
support needs from the neighbouring ranks, point to point
(dist/comm.py::window, batch_isend_irecv within the depth group).

Index math (depth axis; kernel kd, pad pd = kd//2, stride s, local block
of Dl frames at global offset o = s*oz, local codes Dzl = Dl/s):
  - analysis conv: needs the residual on [o-pd, o+Dl+pd) -> exchange a pd
    halo and run the depth-VALID conv; the output is the local codes;
  - synthesis conv-transpose: run on codes extended by hz = ceil(pd/s)+1
    and crop depth [s*hz - pd, s*hz + Dl + pd): the extra taps reference
    kernel offsets outside [0, kd) and add nothing, so the crop is exact;
  - residual blocks: 1-frame halos around each 3x3x3 conv.
Edge ranks get zeros past the global edges: the zero padding the
unsharded conv applies at the clip's boundaries. A halo longer than the
local block comes from the rank that owns those frames, however far
(the JAX package's multi-hop ppermute).

Every rank holds the whole clip batch and gets the whole output; the
gradients are the unsharded forward's, on every rank (dist/comm.py). This
is the route of residual models and of backend "xla" under a depth mesh;
kernel models take dist/halo_fused.py.

Requires D % (n_shards * s) == 0 (true for the 16-frame/s=2 reference
configs on 2/4/8-way meshes).
"""

from __future__ import annotations

import torch

from cdlnet_tpu_torch.core.ops import ST
from cdlnet_tpu_torch.dist.comm import (
    group_index,
    group_size,
    replicate,
    shard,
    unshard,
    window_diff,
    window_plan,
)
from cdlnet_tpu_torch.dist.mesh import as_mesh
from cdlnet_tpu_torch.ops.conv import conv3d, conv_transpose3d
from cdlnet_tpu_torch.ops.lista import _threshold


def halo_exchange(x: torch.Tensor, h_lo: int, h_hi: int, group, dim: int = 2):
    """Extend this rank's block x with h_lo frames from the ranks before it
    and h_hi from the ranks after it along dim (zeros past the global
    edges). Every rank of the group calls it with the same halos. A halo
    longer than the block comes from the rank that holds those frames.
    Differentiable: the backward sends the halo cotangents back to their
    owners, which add them into their frames."""
    n, me, L = group_size(group), group_index(group), x.shape[dim]
    windows = [(r * L - h_lo, (r + 1) * L + h_hi) for r in range(n)]
    return window_diff(x, window_plan(n, L, windows, me), group, dim, L + h_lo + h_hi)


def _res_block_sharded(z, w1, w2, group):
    h = torch.relu(conv3d(halo_exchange(z, 1, 1, group), w1, stride=1, padding=(0, 1, 1)))
    h = conv3d(halo_exchange(h, 1, 1, group), w2, stride=1, padding=(0, 1, 1))
    return torch.relu(h + z)


def _lista_3d_local(yp, A, B, t, c, stride, pad, residual, group):
    """This rank's share of the LISTA loop; yp is its block of frames.
    Returns (xp, z), its block of the synthesis and of the codes."""
    pd, ph, pw = pad
    s = stride
    hz = -(-pd // s) + 1  # ceil(pd/s) + 1: a safe synthesis halo
    n, idx = group_size(group), group_index(group)
    Dl = yp.shape[2]

    yp_ext = halo_exchange(yp, pd, pd, group)
    # the global analysis conv zero-pads the RESIDUAL at the clip's
    # boundaries: window frames past the global range are zeroed. With pd
    # <= Dl only the first and last ranks' windows reach past it (the JAX
    # package's mask); with pd > Dl interior ranks' windows do too
    d = idx * Dl - pd + torch.arange(Dl + 2 * pd, device=yp.device)
    valid = ((d >= 0) & (d < n * Dl)).reshape(1, 1, -1, 1, 1)

    def analysis(r_ext, w):
        return conv3d(r_ext, w, stride=s, padding=(0, ph, pw))

    def synthesis_ext(z, w, lo, hi):
        out = conv_transpose3d(halo_exchange(z, hz, hz, group), w, stride=s,
                               padding=(pd, ph, pw), output_padding=s - 1)
        return out[:, :, s * hz - lo: s * hz + Dl + hi]

    def prox(u, k):
        z = ST(u, _threshold(t[k], c))
        if residual is not None:
            z = _res_block_sharded(z, residual["conv1"][k], residual["conv2"][k], group)
        return z

    z = prox(analysis(yp_ext, A[0]), 0)
    for k in range(1, A.shape[0]):
        r = synthesis_ext(z, B[k], pd, pd) - yp_ext
        r = torch.where(valid, r, torch.zeros_like(r))
        z = prox(z - analysis(r, A[k]), k)
    # the final dictionary synthesis D = B[0], cropped to the local block
    return synthesis_ext(z, B[0], 0, 0), z


def batch_rows(t, group, N):
    """A per-sample tensor's rows for this rank (t's dim 0 has N rows);
    scalars and broadcast tensors as they are."""
    if isinstance(t, torch.Tensor) and t.ndim > 0 and t.shape[0] == N and N > 1:
        return shard(t, group, 0)
    return t


def sharded_lista_3d_forward(model, y, sigma=None, mesh=None, depth_axis: str = "depth",
                             batch_axis: str | None = None, return_z: bool = True):
    """Depth-sharded CDLNetVideo forward over a mesh, on the plain loop.

    y: the whole (N, C, D, H, W) batch on every rank, with D % (mesh depth
    x s) == 0 and H, W divisible by the stride (pre-pad upstream:
    core.preprocess.pre_process_3d). The per-sample mean is taken over the
    whole clip, which every rank holds. Frames shard over depth_axis and,
    with batch_axis, rows over that axis (N divisible by its size).
    Returns (xhat, z or None), whole on every rank."""
    from cdlnet_tpu_torch.models.base import sigma_scale

    mesh = as_mesh(mesh)
    s = model.s
    n_depth = mesh.size(depth_axis)
    if y.shape[2] % (n_depth * s) != 0:
        raise ValueError(
            f"depth {y.shape[2]} must divide mesh depth axis {n_depth} x stride {s}")
    if y.shape[3] % s or y.shape[4] % s:
        raise ValueError("H, W must be divisible by the stride (pre-pad upstream)")
    gd, gb = mesh.group(depth_axis), mesh.group(batch_axis)
    params = {"A": model.A, "B": model.B, "t": model.t}
    if model.residual is not None:
        params.update({f"residual.{k}": v for k, v in model.residual.items()})
    p = replicate(params, (gd, gb))
    residual = None
    if model.residual is not None:
        residual = {k: p[f"residual.{k}"] for k in ("conv1", "conv2")}
    N = y.shape[0]
    c = sigma_scale(sigma, model.adaptive, 5)
    if isinstance(c, torch.Tensor):
        c = batch_rows(c.to(y.device, y.dtype), gb, N)
    mean = y.mean(dim=(1, 2, 3, 4), keepdim=True)
    yl = shard(shard(y - mean, gb, 0), gd, 2)
    xp, z = _lista_3d_local(yl, p["A"], p["B"], p["t"], c, s, model.pad, residual, gd)
    xhat = unshard(unshard(xp, gd, 2), gb, 0) + mean
    if not return_z:
        return xhat, None
    return xhat, unshard(unshard(z, gd, 2), gb, 0)
