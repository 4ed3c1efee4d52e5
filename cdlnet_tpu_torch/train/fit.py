"""The training loop of the image and video workloads (counterpart of the
single-device path of cdlnet_tpu/train/fit.py).

Structure (reference train.py:32-158):
  - epoch loop on the host, per-epoch phases train/val/test ('test' only on
    the final epoch, 'val' every val_freq);
  - the per-batch step: noise injection -> forward -> loss -> backward
    (on backend "pallas"/"cuda" the hand-written reverse kernels) ->
    clipped Adam -> constraint projection; noise comes from a seeded
    torch.Generator on the model's device;
  - PSNR bookkeeping as -10*log10(batch loss), appended to {phase}.txt
    (byte-compatible with the reference's) and to metrics.jsonl;
  - divergence backtracking: if a phase's PSNR drops more than
    backtrack_thresh below its best (or the loss is NaN/Inf), restore the
    last checkpoint (params and optimizer state), scale lr by 0.8, rewind
    the epoch counter (train.py:113-142), log to backtrack.txt; disarmed
    after max_backtracks consecutive restores without a new best.

BatchNorm families (DnCNN, FFDNet) are stateful: the train step runs the
model in train() mode, which updates its running statistics, and the eval
step in eval() mode; checkpoints and backtracking carry the statistics
with the parameters (the JAX package's (params, state) bundle).
ckpt_format="orbax" saves every checkpoint in the background
(train/checkpoint.py: side-write and promote, the JAX orbax backend's job
on .npz bundles); fit settles the pending writes before it restores one
and when it returns or raises. The frame-recurrent CSR models train
through train/fit_csr.py. The losses: mse (the default), the combined
VGG16 loss (loss_type="combmse", for the volumetric workloads) and MC-SURE
(mcsure=True: unsupervised, from the noisy batch alone).

mesh ({"data": ...} and, for the video workloads, "depth"; a dist.mesh.Mesh
or its dict spec) trains on several ranks, one process each
(dist/init.py): every rank loads the same global batch and draws the same
noise, its forward takes its rows (and frames) of it and gathers the
output, so every rank computes the same global loss and takes the same
backtracking branch; the gradients are all-reduced (dist/).

device_scan (train/device_data.py) stages a qualifying train loader's
corpus on the device and runs each training epoch there: batches drawn
and assembled on the device, one step captured into a CUDA graph and
replayed on the card (eagerly under a mesh and on the CPU), the host
synchronized once an epoch.

Tracing and debugging (utils.py, as the JAX package's fit): with
CDLNET_PROFILE_DIR set the first trained epoch is traced by torch.profiler
into that directory, each step a span named "{phase}_step" and a device
epoch one named "train_epoch_scan"; with CDLNET_DEBUG_NANS set every
step's loss is checked and a NaN or Inf raises FloatingPointError (a
device epoch then runs its steps eagerly, without a CUDA graph).
"""

from __future__ import annotations

import math
import os
import time

import torch
from torch.func import functional_call

from cdlnet_tpu_torch.compat import torch_ckpt
from cdlnet_tpu_torch.compat.jax_params import is_stateful, load_jax_params
from cdlnet_tpu_torch.data.noise import awgn, awgn3d, gen_bayer_mask, gen_bayer_mask3d
from cdlnet_tpu_torch.data.prefetch import device_prefetch
from cdlnet_tpu_torch.models.base import build_model
from cdlnet_tpu_torch.train.checkpoint import (
    is_torch_ckpt,
    load_ckpt,
    save_ckpt,
    settles_checkpoints,
)
from cdlnet_tpu_torch.train.losses import combined_loss, mcsure_loss, mse_loss, psnr_from_mse
from cdlnet_tpu_torch.train.optim import get_lr, make_optimizer, set_lr
from cdlnet_tpu_torch.utils import (
    append_metric,
    check_finite,
    debug_nans,
    default_device,
    maybe_start_trace,
    stop_trace,
    trace_span,
)

_NOT_PORTED = "is not ported to cdlnet_tpu_torch yet (see ROADMAP.md)"
_NOT_STAGEABLE = ("device_scan=True but the train loader is not stageable "
                  "(needs a 2D image / 3D clip train loader with "
                  "crop+augment+shuffle+drop_last)")


def init_model(args: dict, seed: int = 0, device=None):
    """Build model + optimizer from a reference-schema args dict (reference
    train.py:180-219), on `device` (the card when None): power-method init
    only when no checkpoint is given. A checkpoint at paths.ckpt restores:
      - a native .npz bundle: params (and running statistics), optimizer
        state, epoch and lr;
      - a reference torch .ckpt: the net state and epoch, then the Adam
        moments and lr when it holds an opt_state_dict, else StepLR's lr
        from its sched_state_dict (train.py:232-247).

    Returns (model, opt, opt_state, epoch0, lr0).
    """
    model_args = dict(args["model"])
    want_init = model_args.pop("init", True)
    model = build_model(args["type"], model_args).to(default_device(device))
    ckpt_path = (args.get("paths") or {}).get("ckpt")
    train_args = args.get("train", {})
    lr = float(train_args.get("opt", {}).get("lr", 1e-3))
    clip_grad = train_args.get("fit", {}).get("clip_grad", 1)
    model.init(torch.Generator().manual_seed(seed),
               init=want_init and ckpt_path is None)
    opt = make_optimizer(lr, clip_grad=clip_grad)
    opt_state = opt.init(dict(model.named_parameters()))
    epoch0 = 0
    if ckpt_path is None:
        return model, opt, opt_state, epoch0, lr
    if is_torch_ckpt(ckpt_path):
        ckpt = torch_ckpt.load_torch_checkpoint(ckpt_path)
        load_jax_params(model, torch_ckpt.import_net_state(model, ckpt["net_state_dict"]))
        epoch0 = ckpt.get("epoch") or 0
        if ckpt.get("opt_state_dict") is not None:
            torch_ckpt.import_opt_state(model, ckpt["opt_state_dict"], opt_state)
            lr = get_lr(opt_state)
        else:
            sched_st = torch_ckpt.import_sched_state(ckpt.get("sched_state_dict"))
            if sched_st is not None:
                lr = torch_ckpt.sched_lr(sched_st)
                set_lr(opt_state, lr)
    else:
        try:
            _, opt_state, epoch0, lr_saved = load_ckpt(ckpt_path, model, opt_state)
        except FileNotFoundError:  # no bundle at the path yet: a fresh run
            lr_saved = None
        if lr_saved is not None:
            set_lr(opt_state, lr_saved)
    return model, opt, opt_state, epoch0, lr


def train_update(model, opt, opt_state, obsrv, sigma, clean, mask=None,
                 project=True, loss_fn=None, forward=None) -> torch.Tensor:
    """One optimizer step on a given noisy batch: forward -> loss ->
    gradients -> clipped Adam -> project(). Parameters and opt_state
    change in place. Returns the loss (a device scalar, not synchronized).

    loss_fn(apply) -> the loss, where apply(y, sigma=sigma, mask=mask) is
    the model's xhat for y (at this call's sigma and mask unless given);
    None is the mse of apply(obsrv) against clean. On a
    BatchNorm family every apply starts from the pre-update running
    statistics, on copies of them, and the first apply's updated copies
    become the model's statistics: the JAX package's functional state, in
    which MC-SURE's perturbed pass discards its own.

    The parameters the model declares unused (its unused_params, CDLNet's
    g) get a zero gradient, as under jax.grad; any other parameter the loss
    does not reach makes autograd raise.

    forward(y, sigma, mask, buffers) -> xhat replaces the model's call
    (the mesh forward of make_train_step), buffers the statistics' copies
    or None."""
    stats = dict(model.named_buffers())
    passes = []

    def apply(y, sigma=sigma, mask=mask):
        copies = None
        if stats:
            copies = {n: b.clone() for n, b in stats.items()}
            passes.append(copies)
        if forward is not None:
            return forward(y, sigma, mask, copies)
        if copies is None:
            return model(y, sigma, mask=mask)[0]
        return functional_call(model, copies, (y, sigma), {"mask": mask})[0]

    loss = mse_loss(apply(obsrv), clean) if loss_fn is None else loss_fn(apply)
    params = dict(model.named_parameters())
    unused = getattr(model, "unused_params", ())
    used = [n for n in params if n not in unused]
    grads = dict(zip(used, torch.autograd.grad(loss, [params[n] for n in used])))
    grads.update({n: torch.zeros_like(params[n]) for n in unused})
    if passes:
        with torch.no_grad():
            for n, b in stats.items():
                b.copy_(passes[0][n])
    opt.update(params, {n: grads[n] for n in params}, opt_state)
    if project:
        model.project()
    return loss.detach()


def make_train_step(model, opt, *, workload="3d", noise_std=(25, 25),
                    demosaic=False, mcsure=False, loss_type="mse", project=True,
                    stateful=None, mesh=None):
    """Build the per-batch steps on the model's device:
      train_step(opt_state, batch, generator) -> loss
        (params and opt_state update in place)
      eval_step(batch, generator) -> loss
    batch: a clean (N, C, D, H, W) clip batch (workload "3d", or "mri":
    fastMRI volumes, the same volumetric step) or (N, C, H, W) image batch
    ("2d") on the model's device; generator: a
    torch.Generator there, which draws the noise (and the per-sample sigma
    when noise_std is a range). demosaic observes through the RGGB Bayer
    mask (2D) or the reference's all-ones 3D mask. stateful (None: the
    model's, compat.jax_params.is_stateful) runs train_step in train()
    mode, which updates a BatchNorm family's running statistics, and
    eval_step in eval() mode, on them (the JAX package's
    make_train_step(stateful=True)). mesh: a dist.mesh.Mesh or dict spec
    (mesh_forward); None runs on this process alone."""
    if workload not in ("2d", "3d", "mri"):
        raise NotImplementedError(f"workload {workload!r} {_NOT_PORTED}")
    if stateful is None:
        stateful = is_stateful(model)
    elif stateful != is_stateful(model):
        raise ValueError(f"stateful={stateful} for {type(model).__name__}, which "
                         f"{'has' if is_stateful(model) else 'has no'} running statistics")
    forward = None if mesh is None else mesh_forward(model, mesh, workload, stateful)
    if loss_type not in ("mse", "combmse"):
        raise ValueError(f"loss_type {loss_type!r} not in ('mse', 'combmse')")
    if loss_type == "combmse" and workload == "2d" and not mcsure:
        raise ValueError("the combined loss takes (N, C, D, H, W) batches: "
                         'workload "3d" or "mri", not "2d"')
    nstd = tuple(noise_std) if isinstance(noise_std, (list, tuple)) else noise_std

    noiser = awgn if workload == "2d" else awgn3d
    bayer = gen_bayer_mask if workload == "2d" else gen_bayer_mask3d

    def observe(batch, generator):
        noisy, sigma = noiser(batch, nstd, generator)
        mask = bayer(batch) if demosaic else None
        return (noisy if mask is None else mask * noisy), sigma, mask

    def train_step(opt_state, batch, generator):
        obsrv, sigma, mask = observe(batch, generator)
        if stateful:
            model.train()
        loss_fn = None
        if mcsure:  # its probe b: the generator's next draw after the noise
            loss_fn = lambda apply: mcsure_loss(apply, obsrv, sigma, generator=generator)
        elif loss_type == "combmse":
            loss_fn = lambda apply: combined_loss(apply(obsrv), batch)
        return train_update(model, opt, opt_state, obsrv, sigma, batch,
                            mask=mask, project=project, loss_fn=loss_fn, forward=forward)

    @torch.no_grad()
    def eval_step(batch, generator):
        obsrv, sigma, mask = observe(batch, generator)
        if stateful:
            model.eval()
        if forward is not None:
            return mse_loss(forward(obsrv, sigma, mask, None), batch)
        xhat, _ = model(obsrv, sigma, mask=mask)
        return mse_loss(xhat, batch)

    return train_step, eval_step


def mesh_forward(model, mesh, workload="3d", stateful=False, axis="data"):
    """The forward of make_train_step under a mesh: forward(y, sigma, mask,
    buffers) -> xhat for the whole batch y, alike on every rank; buffers
    are a stateful family's statistics copies (or None).

    A "depth" axis (video workloads, not stateful) shards the frames of
    a pre-processed clip: on the kernels through dist/halo_fused.py where
    its gate holds (training: the depth-sharded autograd Function), else
    on the plain halo route (dist/halo.py: residual blocks, backend "xla");
    masked input and a clip depth that does not divide run unsharded. The
    "data" axis (or `axis`) shards the rows
    (dist/sharding.py::shard_map_forward; BatchNorm takes the moments of
    the whole batch) where they divide, and the batch runs unsharded on
    every rank where they do not."""
    from cdlnet_tpu_torch.dist.halo_fused import depth_sharded_forward
    from cdlnet_tpu_torch.dist.mesh import as_mesh
    from cdlnet_tpu_torch.dist.sharding import shard_map_forward

    mesh = as_mesh(mesh)
    ndata, ndepth = mesh.size(axis), mesh.size("depth")
    depth = ndepth > 1 and not stateful and workload in ("3d", "mri")

    def call(p, y, sigma, mask, buffers, group=None):
        """The model on y; group: the ranks sharing the batch, whose
        BatchNorm moments are taken together."""
        if stateful:
            model.bn_group = group
        try:
            return functional_call(model, {**p, **(buffers or {})}, (y, sigma),
                                   {"mask": mask})[0]
        finally:
            if stateful:
                model.bn_group = None

    def forward(y, sigma, mask, buffers=None):
        params = dict(model.named_parameters())
        batch_axis = axis if axis in mesh.shape and y.shape[0] % ndata == 0 else None
        if depth and mask is None and y.shape[2] % (ndepth * model.s) == 0:
            return depth_sharded_forward(model, y, sigma, mesh=mesh, batch_axis=batch_axis)
        if batch_axis is None:
            return call(params, y, sigma, mask, buffers)
        group = mesh.group(axis)
        smf = shard_map_forward(mesh, lambda p, yl, sl, ml: call(p, yl, sl, ml, buffers, group),
                                axis)
        return smf(params, y, sigma, mask)

    return forward


@settles_checkpoints
def fit(model, opt, opt_state, loaders, *, save_dir, epochs=1, start_epoch=1,
        noise_std=25, val_freq=1, save_freq=1, backtrack_thresh=1,
        demosaic=False, mcsure=False, loss_type="mse", workload="3d",
        sched=None, verbose=True, epoch_fun=None, seed=0, project=True,
        ckpt_format="npz", mesh=None, max_backtracks=10, device_scan="auto"):
    """Fit model to data. Returns (opt_state, history), history a list of
    (epoch, phase, psnr); the model's parameters are trained in place.

    loaders: {"train", "val", "test"} -> iterables of clean batches, (N, C,
    D, H, W) clips for workload "3d" or "mri" or (N, C, H, W) images for "2d" (numpy
    arrays or tensors), copied to the model's device ahead of the step that
    reads them (data/prefetch.py::device_prefetch). The
    semantics follow the JAX package's fit (module docstring); sched is
    dict(step_size=..., gamma=...) for StepLR. ckpt_format "npz" writes
    each checkpoint before the loop goes on, "orbax" in the background;
    both leave .npz bundles.

    mesh: data-parallel training over the ranks (one process each, every
    rank calling fit with the same arguments): rank 0's parameters are
    broadcast, every train batch's rows split over the mesh's "data" axis
    (the batch size must divide by it), the gradients are all-reduced, and
    every rank logs the same global loss and keeps its own identical
    checkpoints in its save_dir. A "depth" axis also shards the frames of
    video clips (workload "3d" or "mri"; the clip depth must divide by it;
    mesh_forward). The JAX package's reference is single-device
    (train.py:15-16).

    device_scan ("auto", True or False; $CDLNET_DEVICE_SCAN=0 turns it
    off): when train/device_data.py::corpus_from_loader stages the train
    loader (a 2D image or 3D clip DataLoader with crop, augment, shuffle
    and drop_last), every training epoch draws its batches on the device
    and runs as train/device_data.py::EpochRunner: replays of one captured
    step on the card, the same steps eagerly under a mesh (every rank
    stages the whole corpus and draws the same batches) and on the CPU.
    "auto" keeps the host loop for a loader that does not qualify, True
    raises ValueError. The batches' random stream is not the host
    loader's; the epoch's bookkeeping (PSNR, logs, StepLR, backtracking,
    checkpoints) is the host loop's."""
    if ckpt_format not in ("npz", "orbax"):
        raise ValueError(f"ckpt_format {ckpt_format!r} not in ('npz', 'orbax')")
    background = ckpt_format == "orbax"
    dev = next(model.parameters()).device
    corpus = None
    if device_scan and os.environ.get("CDLNET_DEVICE_SCAN", "1") != "0":
        from cdlnet_tpu_torch.train.device_data import corpus_from_loader

        corpus = corpus_from_loader(loaders.get("train"), workload, device=dev)
        if corpus is None and device_scan is True:
            raise ValueError(_NOT_STAGEABLE)
    os.makedirs(save_dir, exist_ok=True)
    check_batch = None
    if mesh is not None:
        from cdlnet_tpu_torch.dist.mesh import as_mesh
        from cdlnet_tpu_torch.dist.sharding import replicate_sharding

        mesh = as_mesh(mesh)
        ndata, ndepth = mesh.size("data"), mesh.size("depth")
        if ndepth > 1 and workload not in ("3d", "mri"):
            raise ValueError('mesh axis "depth" requires a 3D workload (CDLNetVideo)')
        replicate_sharding(model)

        def check_batch(b):
            if b.shape[0] % ndata:
                raise ValueError(
                    f"batch size {b.shape[0]} not divisible by data-parallel "
                    f"axis size {ndata} — adjust train.loaders.batch_size")
            if ndepth > 1 and b.ndim == 5 and b.shape[2] % ndepth:
                raise ValueError(
                    f"clip depth {b.shape[2]} not divisible by depth axis "
                    f"size {ndepth} — adjust train.loaders.depth")
    if not isinstance(noise_std, (list, tuple)):
        noise_std = (noise_std, noise_std)
    train_step, _ = make_train_step(
        model, opt, workload=workload, noise_std=noise_std, demosaic=demosaic,
        mcsure=mcsure, loss_type=loss_type, project=project, mesh=mesh)
    # val/test use the midpoint sigma (train.py:69-72)
    _, eval_step = make_train_step(
        model, opt, workload=workload, noise_std=(noise_std[0] + noise_std[1]) / 2.0,
        demosaic=demosaic, project=project, mesh=mesh)

    epoch_runner = None
    if corpus is not None:
        from cdlnet_tpu_torch.train.device_data import make_epoch_runner

        step = train_step
        if check_batch is not None:  # a mesh: eager steps, each batch checked
            def step(opt_state, batch, generator):
                check_batch(batch)
                return train_step(opt_state, batch, generator)
        # eager under a mesh, and under CDLNET_DEBUG_NANS: anomaly mode's
        # per-op checks read the device, which a CUDA graph capture forbids
        graph = None if mesh is None and not debug_nans() else False
        epoch_runner = make_epoch_runner(corpus, step, model, graph=graph)

    ckpt0 = os.path.join(save_dir, "0.ckpt")
    save_ckpt(ckpt0, model, 0, opt_state, get_lr(opt_state), background=background)
    # bests start at -inf so divergence is only declared relative to an
    # actually recorded best (the reference's 0 livelocks on negative PSNR)
    top_psnr = {"train": -math.inf, "val": -math.inf, "test": -math.inf}
    consecutive_backtracks = 0
    history = []
    gen = torch.Generator(device=dev).manual_seed(seed)
    epoch = start_epoch

    while epoch < start_epoch + epochs:
        diverged = False
        bad = False
        psnr = 0.0
        phase = "train"
        for phase in ["train", "val", "test"]:
            if epoch != epochs and phase == "test":
                continue
            if phase == "val" and epoch % val_freq != 0:
                continue
            t_start = time.time()
            # the first trained epoch goes to $CDLNET_PROFILE_DIR when set
            tracing = phase == "train" and epoch == start_epoch and maybe_start_trace(dev)
            # device scalars: one host transfer per phase, not per step
            losses = []
            if phase == "train" and epoch_runner is not None:
                losses.append(epoch_runner(opt_state, gen))  # a train_epoch_scan span
                check_finite(losses[-1], f"in epoch {epoch}'s train steps")
            else:
                for batch in device_prefetch(loaders[phase], device=dev):
                    with trace_span(f"{phase}_step"):
                        if phase == "train":
                            if check_batch is not None:
                                check_batch(batch)
                            losses.append(train_step(opt_state, batch, gen))
                        else:
                            losses.append(eval_step(batch, gen))
                    check_finite(losses[-1], f"at epoch {epoch} {phase} step {len(losses)}")
            if tracing:
                stop_trace()
            vals = torch.cat([v.reshape(-1) for v in losses]).cpu().tolist() if losses else []
            last_loss = vals[-1] if vals else 0.0
            psnr = sum(psnr_from_mse(v) for v in vals) / max(len(vals), 1)
            if verbose:
                print(f"{phase.upper()}-E{epoch} PSNR: {psnr:.3f} dB "
                      f"({time.time() - t_start:.1f}s, lr={get_lr(opt_state):.2e})")
            history.append((epoch, phase, psnr))
            phase_sec = time.time() - t_start

            bad = math.isnan(last_loss) or math.isinf(last_loss)
            if psnr > top_psnr[phase]:
                top_psnr[phase] = psnr
                consecutive_backtracks = 0
            elif backtrack_thresh is not None and (
                psnr + backtrack_thresh < top_psnr[phase] or bad
            ):
                diverged = True
                break  # phase loop — mirror train.py:116-117

            with open(os.path.join(save_dir, f"{phase}.txt"), "a") as f:
                f.write(f"{psnr:.3f}, ")
            append_metric(save_dir, event="phase", epoch=epoch, phase=phase,
                          psnr=psnr, lr=get_lr(opt_state), steps=len(vals),
                          sec=round(phase_sec, 3))

        if diverged:
            # disarm after max_backtracks restores without a new best, but
            # only for fluctuation: a NaN/Inf loss always restores
            consecutive_backtracks += 1
            if (not bad and max_backtracks is not None
                    and consecutive_backtracks > max_backtracks):
                print(f"Backtracked {consecutive_backtracks - 1}x without a new "
                      "best PSNR — fluctuation, not divergence; disabling the "
                      "backtracking policy for the rest of this run.")
                append_metric(save_dir, event="backtrack_disarmed", epoch=epoch,
                              phase=phase, psnr=psnr,
                              after=consecutive_backtracks - 1)
                backtrack_thresh = None
            else:
                ckpt_path = os.path.join(save_dir, "net.ckpt")
                if epoch <= save_freq:
                    ckpt_path = ckpt0
                print(f"Loss has diverged. Backtracking to {ckpt_path} ...")
                with open(os.path.join(save_dir, "backtrack.txt"), "a") as f:
                    f.write(f"{epoch}  ")
                append_metric(save_dir, event="backtrack", epoch=epoch, phase=phase,
                              psnr=psnr, nan=bad, lr=get_lr(opt_state) * 0.8)
                if epoch % save_freq == 0:
                    epoch = epoch - save_freq
                else:
                    epoch = epoch - epoch % save_freq
                old_lr = get_lr(opt_state)
                load_ckpt(ckpt_path, model, opt_state)
                set_lr(opt_state, old_lr * 0.8)
                print(f"Updated Learning Rate(s): {get_lr(opt_state):.3e}")
                epoch += 1
                continue

        if sched is not None:
            # StepLR: decay lr every step_size epochs (train.py:144-148)
            if epoch % sched["step_size"] == 0:
                set_lr(opt_state, get_lr(opt_state) * sched["gamma"])
                print(f"Updated Learning Rate(s): {get_lr(opt_state):.3e}")

        if epoch % save_freq == 0:
            save_ckpt(os.path.join(save_dir, "net.ckpt"), model, epoch, opt_state,
                      get_lr(opt_state), background=background)
            if epoch_fun is not None:
                epoch_fun(epoch)

        epoch += 1

    return opt_state, history
