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
(mcsure=True: unsupervised, from the noisy batch alone). Not ported yet
(each raises NotImplementedError naming ROADMAP.md): meshes and
one-dispatch device-scan epochs.
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
from cdlnet_tpu_torch.utils import append_metric, default_device

_NOT_PORTED = "is not ported to cdlnet_tpu_torch yet (see ROADMAP.md)"


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
                 project=True, loss_fn=None) -> torch.Tensor:
    """One optimizer step on a given noisy batch: forward -> loss ->
    gradients -> clipped Adam -> project(). Parameters and opt_state
    change in place. Returns the loss (a device scalar, not synchronized).

    loss_fn(apply) -> the loss, where apply(y) is the model's xhat for y at
    sigma (and mask); None is the mse of apply(obsrv) against clean. On a
    BatchNorm family every apply starts from the pre-update running
    statistics, on copies of them, and the first apply's updated copies
    become the model's statistics: the JAX package's functional state, in
    which MC-SURE's perturbed pass discards its own.

    The parameters the model declares unused (its unused_params, CDLNet's
    g) get a zero gradient, as under jax.grad; any other parameter the loss
    does not reach makes autograd raise."""
    stats = dict(model.named_buffers())
    passes = []

    def apply(y):
        if not stats:
            return model(y, sigma, mask=mask)[0]
        copies = {n: b.clone() for n, b in stats.items()}
        passes.append(copies)
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
    make_train_step(stateful=True))."""
    if workload not in ("2d", "3d", "mri"):
        raise NotImplementedError(f"workload {workload!r} {_NOT_PORTED}")
    if stateful is None:
        stateful = is_stateful(model)
    elif stateful != is_stateful(model):
        raise ValueError(f"stateful={stateful} for {type(model).__name__}, which "
                         f"{'has' if is_stateful(model) else 'has no'} running statistics")
    if mesh is not None:
        raise NotImplementedError(f"mesh training {_NOT_PORTED}")
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
                            mask=mask, project=project, loss_fn=loss_fn)

    @torch.no_grad()
    def eval_step(batch, generator):
        obsrv, sigma, mask = observe(batch, generator)
        if stateful:
            model.eval()
        xhat, _ = model(obsrv, sigma, mask=mask)
        return mse_loss(xhat, batch)

    return train_step, eval_step


@settles_checkpoints
def fit(model, opt, opt_state, loaders, *, save_dir, epochs=1, start_epoch=1,
        noise_std=25, val_freq=1, save_freq=1, backtrack_thresh=1,
        demosaic=False, mcsure=False, loss_type="mse", workload="3d",
        sched=None, verbose=True, epoch_fun=None, seed=0, project=True,
        ckpt_format="npz", mesh=None, max_backtracks=10, device_scan=False):
    """Fit model to data. Returns (opt_state, history), history a list of
    (epoch, phase, psnr); the model's parameters are trained in place.

    loaders: {"train", "val", "test"} -> iterables of clean batches, (N, C,
    D, H, W) clips for workload "3d" or "mri" or (N, C, H, W) images for "2d" (numpy
    arrays or tensors), copied to the model's device ahead of the step that
    reads them (data/prefetch.py::device_prefetch). The
    semantics follow the JAX package's fit (module docstring); sched is
    dict(step_size=..., gamma=...) for StepLR. ckpt_format "npz" writes
    each checkpoint before the loop goes on, "orbax" in the background;
    both leave .npz bundles."""
    if ckpt_format not in ("npz", "orbax"):
        raise ValueError(f"ckpt_format {ckpt_format!r} not in ('npz', 'orbax')")
    background = ckpt_format == "orbax"
    if device_scan:
        raise NotImplementedError(f"device_scan {_NOT_PORTED}")
    os.makedirs(save_dir, exist_ok=True)
    dev = next(model.parameters()).device
    if not isinstance(noise_std, (list, tuple)):
        noise_std = (noise_std, noise_std)
    train_step, _ = make_train_step(
        model, opt, workload=workload, noise_std=noise_std, demosaic=demosaic,
        mcsure=mcsure, loss_type=loss_type, project=project, mesh=mesh)
    # val/test use the midpoint sigma (train.py:69-72)
    _, eval_step = make_train_step(
        model, opt, workload=workload, noise_std=(noise_std[0] + noise_std[1]) / 2.0,
        demosaic=demosaic, project=project, mesh=mesh)

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
            # device scalars: one host transfer per phase, not per step
            losses = []
            for batch in device_prefetch(loaders[phase], device=dev):
                if phase == "train":
                    losses.append(train_step(opt_state, batch, gen))
                else:
                    losses.append(eval_step(batch, gen))
            vals = torch.stack(losses).cpu().tolist() if losses else []
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
