"""The training loop of the image and video workloads (counterpart of the
single-device, non-stateful path of cdlnet_tpu/train/fit.py).

Structure (reference train.py:32-158):
  - epoch loop on the host, per-epoch phases train/val/test ('test' only on
    the final epoch, 'val' every val_freq);
  - the per-batch step: noise injection -> forward -> mse -> backward
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

The frame-recurrent CSR models train through train/fit_csr.py. Not ported
yet (each raises NotImplementedError naming ROADMAP.md): meshes, BatchNorm
(stateful) families, one-dispatch device-scan epochs, MC-SURE and the
combined loss, orbax checkpoints.
"""

from __future__ import annotations

import math
import os
import time

import torch

from cdlnet_tpu_torch.data.noise import awgn, awgn3d, gen_bayer_mask, gen_bayer_mask3d
from cdlnet_tpu_torch.data.prefetch import device_prefetch
from cdlnet_tpu_torch.models.base import build_model
from cdlnet_tpu_torch.train.checkpoint import load_ckpt, save_ckpt
from cdlnet_tpu_torch.train.losses import mse_loss, psnr_from_mse
from cdlnet_tpu_torch.train.optim import get_lr, make_optimizer, set_lr
from cdlnet_tpu_torch.utils import append_metric, default_device

_NOT_PORTED = "is not ported to cdlnet_tpu_torch yet (see ROADMAP.md)"


def init_model(args: dict, seed: int = 0, device=None):
    """Build model + optimizer from a reference-schema args dict (reference
    train.py:180-219), on `device` (the card when None): power-method init
    only when no checkpoint is given; a native .npz checkpoint at
    paths.ckpt restores params, optimizer state, epoch and lr.

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
    if ckpt_path is not None and (os.path.exists(ckpt_path)
                                  or os.path.exists(str(ckpt_path) + ".npz")):
        _, opt_state, epoch0, lr_saved = load_ckpt(ckpt_path, model, opt_state)
        if lr_saved is not None:
            set_lr(opt_state, lr_saved)
    return model, opt, opt_state, epoch0, lr


def train_update(model, opt, opt_state, obsrv, sigma, clean, mask=None,
                 project=True) -> torch.Tensor:
    """One optimizer step on a given noisy batch: forward -> mse ->
    gradients -> clipped Adam -> project(). Parameters and opt_state
    change in place. Returns the loss (a device scalar, not synchronized).
    The parameters the model declares unused (its unused_params, CDLNet's
    g) get a zero gradient, as under jax.grad; any other parameter the loss
    does not reach makes autograd raise."""
    xhat, _ = model(obsrv, sigma, mask=mask)
    loss = mse_loss(xhat, clean)
    params = dict(model.named_parameters())
    unused = getattr(model, "unused_params", ())
    used = [n for n in params if n not in unused]
    grads = dict(zip(used, torch.autograd.grad(loss, [params[n] for n in used])))
    grads.update({n: torch.zeros_like(params[n]) for n in unused})
    opt.update(params, {n: grads[n] for n in params}, opt_state)
    if project:
        model.project()
    return loss.detach()


def make_train_step(model, opt, *, workload="3d", noise_std=(25, 25),
                    demosaic=False, mcsure=False, loss_type="mse", project=True,
                    stateful=False, mesh=None):
    """Build the per-batch steps on the model's device:
      train_step(opt_state, batch, generator) -> loss
        (params and opt_state update in place)
      eval_step(batch, generator) -> loss
    batch: a clean (N, C, D, H, W) clip batch (workload "3d", or "mri":
    fastMRI volumes, the same volumetric step) or (N, C, H, W) image batch
    ("2d") on the model's device; generator: a
    torch.Generator there, which draws the noise (and the per-sample sigma
    when noise_std is a range). demosaic observes through the RGGB Bayer
    mask (2D) or the reference's all-ones 3D mask."""
    if workload not in ("2d", "3d", "mri"):
        raise NotImplementedError(f"workload {workload!r} {_NOT_PORTED}")
    for name, unported in (("mcsure", mcsure), ("stateful", stateful),
                           ("mesh", mesh is not None),
                           (f"loss_type={loss_type!r}", loss_type != "mse")):
        if unported:
            raise NotImplementedError(f"{name} training {_NOT_PORTED}")
    nstd = tuple(noise_std) if isinstance(noise_std, (list, tuple)) else noise_std

    noiser = awgn if workload == "2d" else awgn3d
    bayer = gen_bayer_mask if workload == "2d" else gen_bayer_mask3d

    def observe(batch, generator):
        noisy, sigma = noiser(batch, nstd, generator)
        mask = bayer(batch) if demosaic else None
        return (noisy if mask is None else mask * noisy), sigma, mask

    def train_step(opt_state, batch, generator):
        obsrv, sigma, mask = observe(batch, generator)
        return train_update(model, opt, opt_state, obsrv, sigma, batch,
                            mask=mask, project=project)

    @torch.no_grad()
    def eval_step(batch, generator):
        obsrv, sigma, mask = observe(batch, generator)
        xhat, _ = model(obsrv, sigma, mask=mask)
        return mse_loss(xhat, batch)

    return train_step, eval_step


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
    dict(step_size=..., gamma=...) for StepLR."""
    if ckpt_format != "npz":
        raise NotImplementedError(f"ckpt_format={ckpt_format!r} {_NOT_PORTED}")
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
    save_ckpt(ckpt0, model, 0, opt_state, get_lr(opt_state))
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
                      get_lr(opt_state))
            if epoch_fun is not None:
                epoch_fun(epoch)

        epoch += 1

    return opt_state, history
