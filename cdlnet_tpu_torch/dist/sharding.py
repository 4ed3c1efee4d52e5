"""Data parallelism over the batch dim and tensor (subband) parallelism over
the M dim (counterpart of cdlnet_tpu/dist/sharding.py).

Every rank holds the global batch and the replicated parameters. A data
parallel forward takes this rank's rows, runs the unmodified single-rank
forward on them (the hand kernels on the card) and all-gathers the output,
so every rank computes the same loss on the whole batch. Its backward
all-reduces the parameter gradients over the "data" group (one flat sum a
backward: dist/comm.py::replicate), so a step equals the single-process
step on the global batch (SURVEY.md §2.5 DP row).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed as dist

from cdlnet_tpu_torch.dist.comm import (
    all_reduce_,
    broadcast_,
    reduce,
    replicate,
    shard,
    unshard,
)
from cdlnet_tpu_torch.dist.mesh import as_mesh


def batch_sharding(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's rows of a global batch x (dim 0) over the mesh axis; the
    batch size must divide by the axis size."""
    mesh = as_mesh(mesh)
    n = mesh.size(axis)
    if x.shape[0] % n:
        raise ValueError(f"batch size {x.shape[0]} not divisible by {axis!r} axis size {n}")
    rows = x.shape[0] // n
    return x[mesh.index(axis) * rows:(mesh.index(axis) + 1) * rows]


def replicate_sharding(module, mesh=None):
    """Replicate a module's parameters and buffers (or a dict of tensors)
    on every rank: rank 0's values, broadcast in place. A no-op on one
    process. Returns its argument."""
    if not dist.is_initialized():
        return module
    tensors = (list(module.values()) if isinstance(module, dict)
               else [*module.parameters(), *module.buffers()])
    with torch.no_grad():
        for t in tensors:
            broadcast_(t.data if isinstance(t, torch.nn.Parameter) else t, dist.group.WORLD)
    return module


def _infer_sigma_spec(sig: torch.Tensor, y: torch.Tensor) -> str:
    if sig.ndim == 0:
        return "replicate"
    per_sample = (
        sig.ndim == y.ndim
        and sig.shape[0] == y.shape[0]
        and all(d == 1 or d == yd for d, yd in zip(sig.shape[1:], y.shape[1:]))
    )
    if per_sample:
        return "shard"
    if sig.shape[0] == y.shape[0]:
        raise ValueError(
            f"ambiguous sigma shape {tuple(sig.shape)} for batch {tuple(y.shape)}: "
            "reshape per-sample sigmas to (N, 1, ...) matching y's rank, "
            "or pass an explicit sigma_spec"
        )
    return "replicate"


def shard_map_forward(mesh, fn, axis: str = "data", sigma_spec=None):
    """Wrap a forward fn(params, y, sigma, mask, *codes) -> xhat (or a tuple
    of batch-first outputs) so that the batch splits over `axis`.

    The returned forward(params, y, sigma=None, mask=None, *codes) takes
    the whole batch on every rank: it replicates params (their gradients
    all-reduced over the axis), gives fn this rank's rows of y, of mask,
    of each code tensor and of a per-sample sigma, and gathers fn's outputs
    (None outputs stay None), so every rank gets the whole output. Each
    rank runs the unmodified single-rank forward, the hand kernels on the
    card, on its rows: per-row numerics are those of the unsharded call
    on those rows.

    sigma: None passes; scalars replicate; per-sample tensors shard with
    the batch but must be UNAMBIGUOUSLY per-sample: shaped (N, 1, ...)
    broadcastable against y (the models' convention, data/noise.awgn) or
    exactly y-shaped. A bare (N,)-shaped tensor is rejected: its leading
    dim coinciding with the batch size cannot be told apart from a
    broadcast-intended vector. sigma_spec ("shard" or "replicate")
    overrides the inference. Callers guarantee y.shape[0] % axis size ==
    0 (fit checks train batches; ragged eval and serve batches run
    unsharded)."""
    mesh = as_mesh(mesh)

    def forward(params, y, sigma=None, mask=None, *codes):
        group = mesh.group(axis)
        n = mesh.size(axis)
        if y.shape[0] % n:
            raise ValueError(f"batch size {y.shape[0]} not divisible by {axis!r} axis size {n}")
        sig = sigma
        if sigma is not None:
            sig_t = torch.as_tensor(sigma)
            spec = sigma_spec or _infer_sigma_spec(sig_t, y)
            if spec == "shard":
                sig = shard(sig_t.to(y.device), group, 0)
        p = replicate(params, (group,))
        rows = lambda t: None if t is None else shard(t, group, 0)
        out = fn(p, rows(y), sig, rows(mask), *(rows(z) for z in codes))
        gather = lambda t: None if t is None else unshard(t, group, 0)
        return tuple(gather(t) for t in out) if isinstance(out, tuple) else gather(out)

    return forward


def make_dp_train_step(model, opt, loss_fn, mesh, axis: str = "data"):
    """Build a data-parallel train step.

    loss_fn(apply, batch, generator) -> scalar, where apply(y, sigma=None,
    mask=None) is the model's xhat for the whole batch y, computed with
    the batch split over `axis`. Returns (step, prepare):
      step(opt_state, batch, generator=None) -> loss: gradients (all-reduced
        over the axis), clipped Adam, project(); the parameters and
        opt_state change in place, alike on every rank. It is
        train.fit.train_update on train.fit.mesh_forward, the step that
        fit runs under a mesh;
      prepare(opt_state, batch) -> (opt_state, batch): rank 0's parameters
        and optimizer moments on every rank, the batch on the model's
        device."""
    from cdlnet_tpu_torch.compat.jax_params import is_stateful
    from cdlnet_tpu_torch.train.fit import mesh_forward, train_update

    forward = mesh_forward(model, as_mesh(mesh), "2d", is_stateful(model), axis)

    def step(opt_state, batch, generator=None):
        return train_update(model, opt, opt_state, None, None, None,
                            loss_fn=lambda apply: loss_fn(apply, batch, generator),
                            forward=forward)

    def prepare(opt_state, batch):
        dev = next(model.parameters()).device
        replicate_sharding(model)
        replicate_sharding(opt_state["mu"])
        replicate_sharding(opt_state["nu"])
        to = lambda b: torch.as_tensor(np.asarray(b) if not isinstance(b, torch.Tensor) else b).to(dev)
        batch = tuple(to(b) for b in batch) if isinstance(batch, (tuple, list)) else to(batch)
        return opt_state, batch

    return step, prepare


# --- tensor (subband) parallelism ----------------------------------------

# the dim of each bank that holds the M subbands: banks stacked (K, M, ...)
# shard dim 1, threshold banks (K, 2, M, ...) dim 2; the residual blocks'
# convs (K, M, M, 3, 3, 3) shard their output channels, dim 1
_SUBBAND_DIM = {"A": 1, "B": 1, "A2": 1, "B2": 1, "t": 2, "t2": 2, "g": 2, "g1": 2, "g2": 2}


def _subband_dim(name: str):
    if name.startswith("residual."):
        return 1
    return _SUBBAND_DIM.get(name)


def subband_shardings(params: dict, mesh, axis: str = "model") -> dict:
    """Tensor parallelism over the M (subband) dim: this rank's M/n slice of
    every filter and threshold bank of params (name -> tensor, the
    module's named_parameters() names; a nested dict such as residual's
    is sliced alike). Tensors that are not banks are kept whole.

    The per-iteration math is TP-clean: the analysis conv's OUTPUT
    channels are M (sliced, no communication), the soft threshold is per
    subband, and the synthesis contracts over M, one all-reduce a
    synthesis (subband_forward). TP runs on the plain loop: the kernels
    contract over the full M inside (docs/parallelism.md)."""
    mesh = as_mesh(mesh)
    n, i = mesh.size(axis), mesh.index(axis)
    out = {}
    for name, v in params.items():
        if isinstance(v, dict):
            out[name] = {k: _slice(w, 1, n, i) for k, w in v.items()}
            continue
        dim = _subband_dim(name)
        out[name] = v if dim is None else _slice(v, dim, n, i)
    return out


def _slice(v, dim, n, i):
    M = v.shape[dim]
    if M % n:
        raise ValueError(f"{M} subbands do not divide over {n} ranks")
    return v.detach().narrow(dim, i * (M // n), M // n).clone()


def gather_subbands(params_local: dict, mesh, axis: str = "model") -> dict:
    """The full banks from every rank's slices (for checkpoints and
    comparisons): subband_shardings' inverse, on every rank."""
    from cdlnet_tpu_torch.dist.comm import all_gather

    mesh = as_mesh(mesh)
    group = mesh.group(axis)
    out = {}
    for name, v in params_local.items():
        if isinstance(v, dict):
            out[name] = {k: all_gather(w.detach(), group, 1) for k, w in v.items()}
            continue
        dim = _subband_dim(name)
        out[name] = v.detach() if dim is None else all_gather(v.detach(), group, dim)
    return out


def subband_forward(model, params_local: dict, y, sigma=None, mask=None, *, mesh,
                    axis: str = "model", data_axis: str | None = None):
    """The plain LISTA loop of a CDLNet (2D) or CDLNetVideo (3D) with this
    rank's subbands (params_local from subband_shardings of the model's
    named_parameters()): each analysis makes this rank's M/n codes, each
    synthesis sums its partial result over the `axis` group, and residual
    blocks gather the codes they mix. With data_axis the batch also
    splits over that axis (DP x TP). Returns xhat, whole on every rank;
    gradients reach params_local, each rank's slice exactly."""
    from cdlnet_tpu_torch.core.ops import ST
    from cdlnet_tpu_torch.core.preprocess import (
        post_process,
        post_process_3d,
        pre_process,
        pre_process_3d,
    )
    from cdlnet_tpu_torch.models.base import sigma_scale
    from cdlnet_tpu_torch.ops import conv
    from cdlnet_tpu_torch.ops.lista import _lista, _threshold

    mesh = as_mesh(mesh)
    gm, gd = mesh.group(axis), mesh.group(data_axis)
    dims = y.ndim - 2
    if dims not in (2, 3) or not hasattr(model, "pad"):
        raise ValueError(f"subband parallelism runs CDLNet and CDLNetVideo, not {type(model).__name__}")
    p = replicate(params_local, (gd,))
    N = y.shape[0]
    if sigma is not None and not isinstance(sigma, (int, float)):
        sigma = torch.as_tensor(sigma)
        if sigma.ndim > 0 and sigma.shape[0] == N and N > 1:
            sigma = shard(sigma.to(y.device), gd, 0)
    y = shard(y, gd, 0)
    if mask is not None:
        mask = shard(mask, gd, 0)
    pre, post = (pre_process, post_process) if dims == 2 else (pre_process_3d, post_process_3d)
    fwd, adj = (conv.conv2d, conv.conv_transpose2d) if dims == 2 else (conv.conv3d,
                                                                       conv.conv_transpose3d)
    yp, prm, mask = pre(y, model.s, mask=mask)
    c = sigma_scale(sigma, model.adaptive, dims + 2)
    if isinstance(c, torch.Tensor):
        c = c.to(yp.device, yp.dtype)
    s, pad = model.s, model.pad

    def analysis(x, w):  # x is whole on every rank: its cotangent sums over the group
        return fwd(replicate({"x": x}, (gm,))["x"], w, stride=s, padding=pad)

    def synthesis(z, w):
        return reduce(adj(z, w, stride=s, padding=pad, output_padding=s - 1), gm)

    prox = None
    if dims == 3 and "residual.conv1" in p:
        def prox(u, k, c_):
            z = ST(u, _threshold(p["t"][k], c_))
            zf = unshard(z, gm, 1, bwd_sum=True)
            h = torch.relu(conv.conv3d(zf, p["residual.conv1"][k], padding=1))
            h = unshard(h, gm, 1, bwd_sum=True)
            return torch.relu(conv.conv3d(h, p["residual.conv2"][k], padding=1) + z)

    z = _lista(yp, p["A"], p["B"], p["t"], c, mask, analysis, synthesis, prox=prox)
    return unshard(post(synthesis(z, p["B"][0]), prm), gd, 0)


def project_subbands(params_local: dict):
    """In place: the constraint projection (project()) of CDLNet and
    CDLNetVideo on this rank's slices: t >= 0 and each (k, m, c) filter on
    the l2 unit ball over its taps; residual blocks unconstrained."""
    from cdlnet_tpu_torch.core.ops import uball_project

    with torch.no_grad():
        params_local["t"].clamp_(min=0.0)
        for name in ("A", "B"):
            w = params_local[name]
            w.copy_(uball_project(w, axes=tuple(range(3, w.ndim))))
    return params_local


def make_subband_train_step(model, opt, loss_fn, mesh, axis: str = "model",
                            data_axis: str | None = None):
    """A tensor-parallel (and with data_axis, DP x TP) train step on the
    plain loop: step(params_local, opt_state, batch, generator=None) ->
    loss, params_local (name -> leaf tensor, from subband_shardings) and
    opt_state (opt.init(params_local)) updated in place. loss_fn is
    make_dp_train_step's. The global-norm clip takes the norm of the whole
    (gathered) parameters: the slices' squared norms summed over the axis
    group."""
    mesh = as_mesh(mesh)
    gm = mesh.group(axis)
    noclip = copy.copy(opt)
    noclip.clip_grad = None

    def step(params_local, opt_state, batch, generator=None):
        loss = loss_fn(lambda y, sigma=None, mask=None: subband_forward(
            model, params_local, y, sigma, mask, mesh=mesh, axis=axis, data_axis=data_axis),
            batch, generator)
        names = list(params_local)
        grads = dict(zip(names, torch.autograd.grad(loss, [params_local[n] for n in names],
                                                    allow_unused=True)))
        grads = {n: torch.zeros_like(params_local[n]) if g is None else g
                 for n, g in grads.items()}
        if opt.clip_grad is not None:
            sliced = sum(torch.sum(g * g) for n, g in grads.items()
                         if _subband_dim(n) is not None)
            whole = sum(torch.sum(g * g) for n, g in grads.items() if _subband_dim(n) is None)
            sq = torch.as_tensor(sliced, dtype=torch.float32).reshape(1).clone()
            norm = torch.sqrt(all_reduce_(sq, gm)[0] + whole)
            keep = norm < opt.clip_grad
            grads = {n: torch.where(keep, g, (g / norm) * opt.clip_grad) for n, g in grads.items()}
        noclip.update(params_local, grads, opt_state)
        project_subbands(params_local)
        return loss.detach()

    return step
