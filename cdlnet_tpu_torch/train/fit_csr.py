"""The frame-recurrent (CSR) trainer (counterpart of
cdlnet_tpu/train/fit_csr.py).

Reference: traincsr.py:149-277 train_model. Per batch of clean (B, C, D, H,
W) volumes, noise drawn per frame from a seeded torch.Generator on the
model's device:
  - CDLNet_CSR (D >= 2): two rounds of the alternating recurrence with code
    hand-off, net(prev, z_curr) -> z_prev, net(curr, z_prev) -> z_curr;
    loss = MSE(prev) + MSE(curr) (traincsr.py:192-217);
  - CDLNet_CSRf2 (D >= 3): a forward sweep over frames 0, 1, 2, then the
    two-sided refinement passes; loss = the sum of the three frame MSEs
    (traincsr.py:247-273). The reference's line 259 reads `after_denoised`
    before it is assigned (a NameError); here, as in the JAX package, the
    third frame's first pass takes the noisy after-frame. The JAX loss also
    applies the net to the current frame with z_prev alone and discards
    both outputs (its XLA program drops that apply); this eager loop skips
    it: four applies a step.

On backend "pallas"/"cuda" every apply runs the CSR kernels' training path
(models/csr.py: autodiff.csr_fused_2d_train), so the gradient crosses the
frames through the carried codes on the reverse kernels. remat recomputes
each apply in the backward (torch.utils.checkpoint), so the backward holds
one apply's histories at a time instead of all four. No constraint
projection after a step (the reference's CSR trainer never calls
net.project()); project=True enables it.
"""

from __future__ import annotations

import os
import time

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from cdlnet_tpu_torch.data.noise import awgn
from cdlnet_tpu_torch.data.prefetch import device_prefetch
from cdlnet_tpu_torch.models.csr import CDLNetCSRf2
from cdlnet_tpu_torch.train.checkpoint import save_ckpt, settles_checkpoints
from cdlnet_tpu_torch.train.losses import mse_loss, psnr_from_mse
from cdlnet_tpu_torch.train.optim import get_lr, set_lr
from cdlnet_tpu_torch.utils import append_metric, check_finite

# remat="auto" recomputes the applies past this many pixels a frame: the
# JAX package's threshold, between the half-native 320x184 frame and the
# native 640x368 one (cdlnet_tpu/train/fit_csr.py:37-57)
REMAT_PIXELS = 100_000


def make_csr_train_step(model, opt, *, noise_std, project=False, remat="auto", mesh=None):
    """Build the CSR steps on the model's device (2-frame alternating
    recurrence for CDLNet_CSR, 3-frame bidirectional for CDLNet_CSRf2):
      train_step(opt_state, batch, generator) -> loss
        (parameters and opt_state update in place)
      eval_step(batch, generator) -> loss
    batch: clean (B, C, D, H, W) volumes on the model's device (the first
    two or three frames are read); generator: a torch.Generator there,
    which draws each frame's noise (and its per-sample sigma when
    noise_std is a range). remat: True, False, or "auto" (on past
    REMAT_PIXELS pixels a frame). mesh: a dist.mesh.Mesh or dict spec
    whose "data" axis splits every apply's rows (volumes) over the ranks
    where they divide (dist/sharding.py::shard_map_forward: the carried
    codes are gathered and split again, so every rank computes the same
    loss; the gradients are all-reduced)."""
    nstd = tuple(noise_std) if isinstance(noise_std, (list, tuple)) else noise_std
    is_f2 = isinstance(model, CDLNetCSRf2)
    ndata = 1
    if mesh is not None:
        from cdlnet_tpu_torch.dist.mesh import as_mesh
        from cdlnet_tpu_torch.dist.sharding import shard_map_forward

        mesh = as_mesh(mesh)
        ndata = mesh.size("data")

    def loss_fn(batch, generator):
        use_remat = (remat if remat != "auto"
                     else batch.shape[-2] * batch.shape[-1] > REMAT_PIXELS)

        remat_on = use_remat and torch.is_grad_enabled()

        def run(fn, *args):
            if remat_on:
                return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
            return fn(*args)

        def apply(*args):  # (y, *codes, sigma)
            if mesh is not None and args[0].shape[0] % ndata == 0:
                smf = shard_map_forward(mesh, lambda p, y, sig, _, *codes: run(
                    lambda *a: functional_call(model, p, a), y, *codes, sig))
                return smf(dict(model.named_parameters()), args[0], args[-1], None,
                           *args[1:-1])
            return run(model, *args)

        prev, curr = batch[:, :, 0], batch[:, :, 1]
        prev_hat, s1 = awgn(prev, nstd, generator)
        curr_hat, s2 = awgn(curr, nstd, generator)
        if not is_f2:
            # round 1: the first-frame bank, then the recurrence; round 2:
            # both frames carry codes
            _, z_prev = apply(prev_hat, None, s1)
            _, z_curr = apply(curr_hat, z_prev, s2)
            prev_d, z_prev = apply(prev_hat, z_curr, s1)
            curr_d, _ = apply(curr_hat, z_prev, s2)
            return mse_loss(prev_d, prev) + mse_loss(curr_d, curr)
        after = batch[:, :, 2]
        after_hat, s3 = awgn(after, nstd, generator)
        _, z_prev = apply(prev_hat, None, None, s1)
        after_d, z_after = apply(after_hat, z_prev, None, s3)
        curr_d, _ = apply(curr_hat, z_prev, z_after, s2)
        prev_d, _ = apply(prev_hat, None, z_after, s1)
        return mse_loss(prev_d, prev) + mse_loss(curr_d, curr) + mse_loss(after_d, after)

    def train_step(opt_state, batch, generator):
        loss = loss_fn(batch, generator)
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.update(params, dict(zip(params, grads)), opt_state)
        if project:
            model.project()
        return loss.detach()

    @torch.no_grad()
    def eval_step(batch, generator):
        return loss_fn(batch, generator)

    return train_step, eval_step


@settles_checkpoints
def fit_csr(model, opt, opt_state, loaders, *, save_dir, epochs=1, start_epoch=1,
            noise_std=25, val_freq=1, save_freq=1, sched=None, verbose=True,
            epoch_fun=None, seed=0, project=False, mesh=None, ckpt_format="npz",
            **ignored):
    """Fit a frame-recurrent CSR(f2) model (reference traincsr.py:50-147).
    Returns (opt_state, history), history a list of (epoch, phase, psnr);
    the model's parameters are trained in place.

    loaders: {"train", "val", "test"} -> iterables of clean (B, C, D, H, W)
    volume batches (numpy arrays or tensors), copied to the model's device
    ahead of the step (data/prefetch.py::device_prefetch). Per epoch the phases train / val (every val_freq) / test (the last
    epoch), the same artifacts as fit(): {phase}.txt, metrics.jsonl rows,
    0.ckpt, net_epoch_{epoch}.ckpt and net.ckpt npz bundles every
    save_freq epochs, and the StepLR sched (dict(step_size=..., gamma=...)).
    val and test draw their noise at the midpoint sigma. As in the JAX
    package there is no backtracking; fit's other keys (backtrack_thresh,
    mcsure, demosaic, ...) land in `ignored` and are named. ckpt_format
    "orbax" saves in the background, as fit does. mesh: data parallelism
    as in fit (make_csr_train_step; a train batch's size must divide by
    the "data" axis)."""
    if ckpt_format not in ("npz", "orbax"):
        raise ValueError(f"ckpt_format {ckpt_format!r} not in ('npz', 'orbax')")
    background = ckpt_format == "orbax"
    if ignored:  # fit's keys the CSR path has no use for: name them
        print(f"fit_csr: ignoring fit args {sorted(ignored)}")
    os.makedirs(save_dir, exist_ok=True)
    dev = next(model.parameters()).device
    ndata = 1
    if mesh is not None:
        from cdlnet_tpu_torch.dist.mesh import as_mesh
        from cdlnet_tpu_torch.dist.sharding import replicate_sharding

        mesh = as_mesh(mesh)
        ndata = mesh.size("data")
        replicate_sharding(model)
    if not isinstance(noise_std, (list, tuple)):
        noise_std = (noise_std, noise_std)
    train_step, _ = make_csr_train_step(model, opt, noise_std=noise_std, project=project,
                                        mesh=mesh)
    _, eval_step = make_csr_train_step(model, opt,
                                       noise_std=(noise_std[0] + noise_std[1]) / 2.0,
                                       project=project, mesh=mesh)

    save_ckpt(os.path.join(save_dir, "0.ckpt"), model, 0, opt_state, get_lr(opt_state),
              background=background)
    history = []
    gen = torch.Generator(device=dev).manual_seed(seed)
    for epoch in range(start_epoch, start_epoch + epochs):
        for phase in ["train", "val", "test"]:
            if epoch != epochs and phase == "test":
                continue
            if phase == "val" and epoch % val_freq != 0:
                continue
            t_start = time.time()
            losses = []  # device scalars: one host transfer per phase
            for batch in device_prefetch(loaders[phase], device=dev):
                if phase == "train":
                    if batch.shape[0] % ndata:
                        raise ValueError(f"batch size {batch.shape[0]} not divisible "
                                         f"by data axis {ndata}")
                    losses.append(train_step(opt_state, batch, gen))
                else:
                    losses.append(eval_step(batch, gen))
                check_finite(losses[-1], f"at epoch {epoch} {phase} step {len(losses)}")
            vals = torch.stack(losses).cpu().tolist() if losses else []
            psnr = sum(psnr_from_mse(v) for v in vals) / max(len(vals), 1)
            history.append((epoch, phase, psnr))
            phase_sec = time.time() - t_start
            if verbose:
                print(f"{phase.upper()}-E{epoch} PSNR: {psnr:.3f} dB ({phase_sec:.1f}s)")
            with open(os.path.join(save_dir, f"{phase}.txt"), "a") as f:
                f.write(f"{psnr:.3f}, ")
            append_metric(save_dir, event="phase", epoch=epoch, phase=phase, psnr=psnr,
                          lr=get_lr(opt_state), steps=len(vals), sec=round(phase_sec, 3))

        if sched is not None and epoch % sched["step_size"] == 0:
            set_lr(opt_state, get_lr(opt_state) * sched["gamma"])
        if epoch % save_freq == 0:
            for name in (f"net_epoch_{epoch}.ckpt", "net.ckpt"):
                save_ckpt(os.path.join(save_dir, name), model, epoch, opt_state,
                          get_lr(opt_state), background=background)
            if epoch_fun is not None:
                epoch_fun(epoch)
    return opt_state, history
