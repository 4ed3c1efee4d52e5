#!/usr/bin/env python3
"""fastMRI / CSR analysis CLI: `python -m cdlnet_tpu_torch.cli.analyzemri
argscsr.json [flags]` (counterpart of cdlnet_tpu/cli/analyzemri.py), on the
card unless main() is given device="cpu".

The reference MRI analyzer (analyzemri.py:25-38) adds SSIM to the PSNR
protocol and dispatches per model type (analyzemri.py:216-247):
  CDLNet_CSR,   the model's frame recurrence (video_denoise): the warm-up
  CDLNet_CSRf2  and forward recurrence, or the two passes
  CDLNet/GDLNet each volume's slices as one frame batch
  DnCNN/FFDNet  the same, in eval() mode on the running statistics (the
                JAX CLI cannot run them: it passes their (params, state)
                bundle to apply and takes the (xhat, n) pair for xhat)
  CDLNetVideo   the volumetric forward (the 3D kernels)

--test DIR reads the .h5 k-space volumes of DIR (the first `depth` slices
of each, depth from the config's train.loaders, 16 by default; needs h5py)
and appends "sigma, PSNR: p, SSIM: s" lines to test_{dset}_{blind}.txt and
an eval row to metrics.jsonl; --save also dumps the clean frames
(test_gt/). --passthrough DIR runs one video directory: through the
recurrence for the CSR models (psnr.txt), else as cli/analyze.py or
cli/analyze3d.py do. --dictionary, --thresholds and --filters are the 2D
or 3D commands by the model's dimension. --blind MAD or PCA: one sigma per
volume, the mean of the framewise estimates (models/csr.py::blind_sigma).
The noise comes from a torch.Generator seeded 0 per noise level, so
the PSNRs are not the JAX CLI's digit for digit.
"""

from __future__ import annotations

import json
import os
from pprint import pprint

import numpy as np
import torch

from cdlnet_tpu_torch.cli import analyze, analyze3d
from cdlnet_tpu_torch.cli import train as cli_train
from cdlnet_tpu_torch.cli.analyze import build_argparser, resolve_noise_levels
from cdlnet_tpu_torch.cli.analyze3d import _save_frames
from cdlnet_tpu_torch.data.noise import awgn3d, gen_bayer_mask3d
from cdlnet_tpu_torch.models.csr import blind_sigma
from cdlnet_tpu_torch.train.losses import ssim
from cdlnet_tpu_torch.utils import append_metric, load_video, psnr, setup_debug

CSR_TYPES = ("CDLNet_CSR", "CDLNet_CSRf2")
FRAME_TYPES = ("CDLNet", "GDLNet", "DnCNN", "FFDNet")


def _ssim_frames(x, xhat):
    """Frame-averaged SSIM of two (B, C, D, H, W) clips (analyzemri.py:258-267;
    gaussian 11x11 window, data_range 1, the training loss's SSIM)."""
    B, C, D, H, W = x.shape
    xf = x.transpose(1, 2).reshape(B * D, C, H, W)
    yf = xhat.transpose(1, 2).reshape(B * D, C, H, W)
    return float(ssim(yf, xf, data_range=1.0))


def forward_for(model, mtype):
    """The volume denoiser of a model type: (B, C, D, H, W), sigma ->
    (B, C, D, H, W)."""
    if mtype in CSR_TYPES:
        return lambda y, s: model.video_denoise(y, s)[0]
    if mtype in FRAME_TYPES:
        def run(y, s):
            # a volume as one frame batch through the 2D net (analyzemri.py:229-235)
            if y.shape[0] != 1:
                raise ValueError("the 2D dispatch takes batch-size-1 volumes")
            return model(y[0].transpose(0, 1), s)[0].transpose(0, 1)[None]
        return run
    return lambda y, s: model(y, s)[0]  # CDLNetVideo


@torch.inference_mode()
def test(model, mtype, loader, noise_levels, blind, save_dir, save, demosaic):
    # dataset name = the h5 files' containing dir (analyzemri.py:191)
    dset = os.path.basename(os.path.dirname(loader.dataset.h5_files[0]))
    fn = os.path.join(save_dir, f"test_{dset}_{blind}.txt")
    if save:
        for sub in ("test_noise", "test_output", "test_gt"):
            os.makedirs(os.path.join(save_dir, sub), exist_ok=True)
    dev = next(model.parameters()).device
    run = forward_for(model, mtype)

    for sigma in noise_levels:
        psnr_total, ssim_total, count, frames_done = 0.0, 0.0, 0, 0
        gen = torch.Generator(device=dev).manual_seed(0)
        for x in loader:
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)  # (B, C, D, H, W)
            if demosaic:
                x = gen_bayer_mask3d(x) * x  # all ones (utils.py:21-27)
            y, _ = awgn3d(x, float(sigma), gen)
            s = None
            if model.adaptive:
                s = float(sigma)
                if blind:
                    s = blind_sigma(y, blind)
                    print(f"sigma_hat = {float(s):.3f}")
            xhat = run(y, s)
            x_np, xhat_np = x.cpu().numpy(), xhat.cpu().numpy()
            mse = float(np.mean((x_np.astype(np.float64) - xhat_np.astype(np.float64)) ** 2))
            psnr_total += -10.0 * np.log10(max(mse, 1e-12))
            ssim_total += _ssim_frames(x, xhat) * x.shape[0] * x.shape[2]
            count += 1
            if save:
                _save_frames(os.path.join(save_dir, "test_noise"), "noise", y.cpu().numpy(),
                             frames_done)
                _save_frames(os.path.join(save_dir, "test_output"), "output", xhat_np,
                             frames_done)
                _save_frames(os.path.join(save_dir, "test_gt"), "gt", x_np, frames_done)
            frames_done += x.shape[0] * x.shape[2]
        avg_psnr = psnr_total / max(count, 1)
        avg_ssim = ssim_total / max(frames_done, 1)
        print(f"sigma={sigma}: PSNR = {avg_psnr:.3f}, SSIM = {avg_ssim:.4f}")
        with open(fn, "a") as f:
            f.write(f"{sigma}, PSNR: {avg_psnr:.3f}, SSIM: {avg_ssim:.4f}\n")
        append_metric(save_dir, event="eval", dataset=dset, blind=str(blind),
                      sigma=float(sigma), psnr=avg_psnr, ssim=avg_ssim,
                      volumes=count, frames=frames_done)
    print(f"saved to file {fn}")


@torch.inference_mode()
def passthrough_csr(model, mtype, video_path, noise_std, save_dir, blind, color, save):
    """One video directory through the frame recurrence of a CSR model:
    psnr.txt, and with --save the noisy and denoised frames. Returns the
    PSNR. (The reference's passthrough calls a CSR net as a 2D one; the JAX
    package runs the recurrences, as here.)"""
    name = os.path.splitext(os.path.basename(os.path.normpath(video_path)))[0]
    out_dir = os.path.join(save_dir, f"passthrough_{name}")
    os.makedirs(out_dir, exist_ok=True)
    dev = next(model.parameters()).device

    x = torch.from_numpy(load_video(video_path, gray=not color)).to(dev)  # (1, C, D, H, W)
    y, _ = awgn3d(x, float(noise_std), torch.Generator(device=dev).manual_seed(0))
    sigma = float(noise_std)
    if model.adaptive and blind:
        sigma = blind_sigma(y, blind)
        print(f"sigma_hat = {float(sigma):.3f}")
    xhat = forward_for(model, mtype)(y, sigma)
    x, y, xhat = (v.cpu().numpy() for v in (x, y, xhat))
    p = psnr(x, xhat)
    print(f"PSNR: {p:.2f} dB")
    if save:
        _save_frames(out_dir, "noise", y, 0)
        _save_frames(out_dir, "output", xhat, 0)
    with open(os.path.join(out_dir, "psnr.txt"), "w") as f:
        f.write(f"PSNR: {p:.2f} dB\n")
    return p


def main(ARGS, model_args, device=None):
    """Run the analyses ARGS asks for on the model model_args describes
    (its checkpoint at paths.ckpt, else the init), on `device`: the card
    when None."""
    from cdlnet_tpu_torch.data.fastmri import get_fastmri_data_loader
    from cdlnet_tpu_torch.train.fit import init_model

    setup_debug()
    model_args = cli_train.apply_backend(ARGS.backend, model_args)
    model = init_model(model_args, device=device)[0].eval()
    mtype = model_args["type"]
    is_video = mtype == "CDLNetVideo"

    save_dir = ARGS.save_dir or model_args["paths"]["save"]
    os.makedirs(save_dir, exist_ok=True)
    noise_levels = resolve_noise_levels(ARGS, model_args)
    nl0 = noise_levels[0]

    if ARGS.test is not None:
        loader = get_fastmri_data_loader(
            [ARGS.test], depth=model_args["train"]["loaders"].get("depth", 16), PDFS=False)
        test(model, mtype, loader, noise_levels, ARGS.blind, save_dir, ARGS.save,
             ARGS.demosaic)

    # weight introspection by the model's dimension
    viz = analyze3d if is_video else analyze
    if ARGS.dictionary:
        viz.dictionary(model, save_dir)
    if ARGS.passthrough is not None:
        if is_video:
            analyze3d.passthrough(model, ARGS.passthrough, nl0, save_dir, ARGS.blind,
                                  ARGS.color, ARGS.demosaic, ARGS.save)
        elif mtype in CSR_TYPES:
            passthrough_csr(model, mtype, ARGS.passthrough, nl0, save_dir, ARGS.blind,
                            ARGS.color, ARGS.save)
        else:
            analyze.passthrough(model, ARGS.passthrough, nl0, save_dir, ARGS.blind,
                                ARGS.color, ARGS.demosaic, ARGS.save)
    if ARGS.thresholds:
        viz.thresholds(model, save_dir, noise_level=nl0)
    if ARGS.filters:
        viz.filters(model, save_dir, scale_each=True)


def cli():
    """Console entry point."""
    ARGS = build_argparser().parse_args()
    with open(ARGS.args_fn) as f:
        model_args = json.load(f)
    pprint(model_args)
    main(ARGS, model_args)


if __name__ == "__main__":
    cli()
