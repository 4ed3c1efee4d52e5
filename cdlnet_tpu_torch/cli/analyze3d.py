#!/usr/bin/env python3
"""Video analysis CLI: `python -m cdlnet_tpu_torch.cli.analyze3d args.json
[flags]` (counterpart of cdlnet_tpu/cli/analyze3d.py), for CDLNetVideo on
the card unless main() is given device="cpu".

  --test DIR        16-frame-clip PSNR sweep over the --noise_level values
                    on the first 16 frames of every video directory in DIR
                    at full resolution; "sigma, PSNR" lines appended to
                    {save_dir}/test_{dset}_{blind}.txt, an eval row to
                    metrics.jsonl, and with --save per-frame noisy/output
                    PNGs
  --dictionary      the synthesis dictionary (central temporal slice) and
                    its FFT magnitude response
  --passthrough DIR one video directory with per-iteration code dumps
                    (CDLNetVideo.apply_with_codes)
  --thresholds      tau heatmap over (iteration, subband); needs matplotlib
  --filters         A/B filter grids per iteration (central slice)
  --blind MAD|PCA   blind noise-level estimation: the 2D estimator
                    framewise, averaged per clip
  --noise_level, --save, --save_dir, --color, --demosaic, --backend

The files it writes have the JAX CLI's names and formats. The noise comes
from a torch.Generator seeded 0 per noise level, so the PSNRs are not the
JAX CLI's digit for digit.
"""

from __future__ import annotations

import json
import os
from pprint import pprint

import numpy as np
import torch

from cdlnet_tpu_torch import nle
from cdlnet_tpu_torch.cli import train as cli_train
from cdlnet_tpu_torch.cli.analyze import build_argparser, resolve_noise_levels
from cdlnet_tpu_torch.data.noise import awgn3d, gen_bayer_mask3d
from cdlnet_tpu_torch.utils import (
    append_metric,
    img_save,
    load_video,
    make_grid,
    psnr,
    setup_debug,
)


def _central_slice(W5):
    """(K, M, C, Pd, Ph, Pw) 3D filter stack -> (K, M, C, Ph, Pw) middle frame."""
    W5 = W5.detach().cpu().numpy()
    return W5[..., W5.shape[-3] // 2, :, :]


def _save_frames(dir_, prefix, clip, start):
    """Dump a (B, C, D, H, W) clip as numbered per-frame PNGs."""
    clip = np.clip(np.asarray(clip), 0.0, 1.0)
    B, _, D = clip.shape[:3]
    for b in range(B):
        for d in range(D):
            n = start + b * D + d + 1
            img_save(os.path.join(dir_, f"{prefix}_{n:05d}.png"), clip[b, :, d])


def _blind_sigma(y, blind):
    """255 * the framewise noise-level estimates of y (B, C, D, H, W): (B, D)."""
    B, C, D, H, W = y.shape
    s_hat = nle.noise_level(y.transpose(1, 2).reshape(B * D, C, H, W), method=blind)
    return 255.0 * s_hat.reshape(B, D)


def _observe(x, sigma, generator, demosaic):
    """(noisy observation, mask or None) of the clean clip batch x."""
    mask = gen_bayer_mask3d(x) if demosaic else None
    y, _ = awgn3d(x, float(sigma), generator)
    return (y if mask is None else mask * y), mask


@torch.inference_mode()
def test(model, loader, noise_levels, blind, save_dir, save, demosaic):
    # dataset name = the test dir itself (the reference's
    # basename(dirname(video_dir)), video_dir a subdir of the --test dir)
    dset = os.path.basename(os.path.normpath(loader.dataset.root_dirs[0]))
    fn = os.path.join(save_dir, f"test_{dset}_{blind}.txt")
    if save:
        os.makedirs(os.path.join(save_dir, "test_noise"), exist_ok=True)
        os.makedirs(os.path.join(save_dir, "test_output"), exist_ok=True)
    dev = next(model.parameters()).device

    for sigma in noise_levels:
        total, count, frames_done = 0.0, 0, 0
        gen = torch.Generator(device=dev).manual_seed(0)
        for x in loader:
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)  # (B, C, D, H, W)
            if x.shape[2] != 16:
                raise ValueError(f"Expected depth=16, got depth={x.shape[2]}")
            y, mask = _observe(x, sigma, gen, demosaic)
            s = None
            if model.adaptive:
                s = float(sigma)
                if blind:
                    # the 2D estimator framewise, averaged per clip
                    s = _blind_sigma(y, blind).mean(dim=1)
                    print(f"sigma_hat = {float(s[0]):.3f}")
            xhat = model(y, s, mask=mask)[0]
            # clip PSNR from the 5D MSE per video, batch-averaged
            x_np = x.cpu().numpy().astype(np.float64)
            xhat_np = xhat.cpu().numpy()
            mse = np.mean((x_np - xhat_np.astype(np.float64)) ** 2, axis=(1, 2, 3, 4))
            total += float(np.mean(-10.0 * np.log10(np.maximum(mse, 1e-12))))
            count += 1
            if save:
                _save_frames(os.path.join(save_dir, "test_noise"), "noise", y.cpu().numpy(),
                             frames_done)
                _save_frames(os.path.join(save_dir, "test_output"), "output", xhat_np,
                             frames_done)
            frames_done += x.shape[0] * x.shape[2]
        avg = total / max(count, 1)
        print(f"sigma={sigma}: PSNR = {avg:.3f}")
        with open(fn, "a") as f:
            f.write(f"{sigma}, {avg:.3f}\n")
        append_metric(save_dir, event="eval", dataset=dset, blind=str(blind),
                      sigma=float(sigma), psnr=avg, clips=count, frames=frames_done)
    print(f"saved to file {fn}")


def thresholds(model, save_dir, noise_level=25):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = 1 if model.adaptive else 0
    t = model.t.detach().cpu().numpy()  # (K, 2, M, 1, 1, 1)
    tau = (t[:, 0] + c * (noise_level / 255.0) * t[:, 1]).reshape(t.shape[0], t.shape[2])
    fig, ax = plt.subplots()
    im = ax.imshow(tau, cmap="hot", vmin=0, vmax=tau.max())
    plt.xlabel("j (subband)")
    plt.ylabel("k (iteration)")
    plt.colorbar(im)
    fn = os.path.join(save_dir, "tau.png")
    plt.savefig(fn, dpi=300, bbox_inches="tight")
    plt.close(fig)
    print(f"saved {fn}")


def filters(model, save_dir, scale_each=True):
    A, B = _central_slice(model.A), _central_slice(model.B)
    out_dir = os.path.join(save_dir, "filters")
    os.makedirs(out_dir, exist_ok=True)
    n = int(np.ceil(np.sqrt(A.shape[1])))
    mmax = max(np.abs(A).max(), np.abs(np.concatenate([0 * B[:1], B[1:]])).max())
    for k in range(A.shape[0]):
        Bk = 0 * B[k] if k == 0 else B[k]
        vr = None if scale_each else (-mmax, mmax)
        Ag = make_grid(A[k], nrow=n, normalize_each=scale_each, value_range=vr)
        Bg = make_grid(Bk, nrow=n, normalize_each=scale_each, value_range=vr)
        gap = np.ones((Ag.shape[0], Ag.shape[1], 5), np.float32)
        img_save(os.path.join(out_dir, f"AB{k:02d}_{scale_each}.png"),
                 np.concatenate([Ag, gap, Bg], axis=2))
    img_save(os.path.join(out_dir, f"D_filters_{scale_each}.png"),
             make_grid(B[0], nrow=n, normalize_each=True))
    print(f"saved filter grids to {out_dir}")


def dictionary(model, save_dir):
    D = _central_slice(model.B)[0]  # (M, C, Ph, Pw)
    n = int(np.ceil(np.sqrt(D.shape[0])))
    img_save(os.path.join(save_dir, "D_learned.png"), make_grid(D, nrow=n, normalize_each=True))
    X = np.fft.fftshift(np.fft.fft2(D, s=(64, 64)), axes=(-2, -1))
    img_save(os.path.join(save_dir, "freq_response.png"),
             make_grid(np.abs(X).astype(np.float32), nrow=n, padding=10, normalize_each=True))
    print(f"saved D_learned.png, freq_response.png to {save_dir}")


@torch.inference_mode()
def passthrough(model, video_path, noise_std, save_dir, blind, color, demosaic, save):
    """Denoise one video directory and dump every iteration's codes
    (central code frame) with --save. Returns the PSNR."""
    name = os.path.splitext(os.path.basename(os.path.normpath(video_path)))[0]
    out_dir = os.path.join(save_dir, f"passthrough_{name}")
    os.makedirs(out_dir, exist_ok=True)
    dev = next(model.parameters()).device

    x = torch.from_numpy(load_video(video_path, gray=not color)).to(dev)  # (1, C, D, H, W)
    y, mask = _observe(x, noise_std, torch.Generator(device=dev).manual_seed(0), demosaic)
    sigma = None
    if model.adaptive:
        sigma = float(noise_std)
        if blind:
            sigma = float(_blind_sigma(y, blind).mean())
            print(f"sigma_hat = {sigma:.3f}")

    xhat, _, codes = model.apply_with_codes(y, sigma, mask=mask)
    x, y, xhat = (v.cpu().numpy() for v in (x, y, xhat))
    p = psnr(x, xhat)
    print(f"PSNR: {p:.2f} dB")

    if save:
        _save_frames(out_dir, "noise", y, 0)
        _save_frames(out_dir, "output", xhat, 0)
        n = int(np.ceil(np.sqrt(model.M)))
        mid = codes.shape[3] // 2  # central code frame per iteration
        for i in range(codes.shape[0]):
            csc = codes[i, 0, :, mid].abs().cpu().numpy()[:, None]  # (M, 1, h, w)
            img_save(os.path.join(out_dir, f"csc{i:02d}.png"),
                     make_grid(csc / max(csc.max(), 1e-8), nrow=n, padding=10))
        # side by side per frame: noisy | output | ground truth
        cmp = np.concatenate([np.clip(v, 0, 1) for v in (y, xhat, x)], axis=4)
        _save_frames(out_dir, "compare", cmp, 0)
    with open(os.path.join(out_dir, "psnr.txt"), "w") as f:
        f.write(f"PSNR: {p:.2f} dB\n")
    return p


def main(ARGS, model_args, device=None):
    """Run the analyses ARGS asks for on the model model_args describes
    (its checkpoint at paths.ckpt, else the init), on `device`: the card
    when None."""
    from cdlnet_tpu_torch.data.video import get_video_loader
    from cdlnet_tpu_torch.train.fit import init_model

    setup_debug()
    model_args = cli_train.apply_backend(ARGS.backend, model_args)
    model = init_model(model_args, device=device)[0].eval()

    save_dir = ARGS.save_dir or model_args["paths"]["save"]
    os.makedirs(save_dir, exist_ok=True)
    noise_levels = resolve_noise_levels(ARGS, model_args)
    nl0 = noise_levels[0] if isinstance(noise_levels, (list, tuple)) else noise_levels

    if ARGS.test is not None:
        loader = get_video_loader([ARGS.test], load_color=ARGS.color, test=True, depth=16)
        test(model, loader, noise_levels, ARGS.blind, save_dir, ARGS.save, ARGS.demosaic)
    if ARGS.dictionary:
        dictionary(model, save_dir)
    if ARGS.passthrough is not None:
        passthrough(model, ARGS.passthrough, nl0, save_dir, ARGS.blind, ARGS.color,
                    ARGS.demosaic, ARGS.save)
    if ARGS.thresholds:
        thresholds(model, save_dir, noise_level=nl0)
    if ARGS.filters:
        filters(model, save_dir, scale_each=True)


def cli():
    """Console entry point."""
    ARGS = build_argparser().parse_args()
    with open(ARGS.args_fn) as f:
        model_args = json.load(f)
    pprint(model_args)
    main(ARGS, model_args)


if __name__ == "__main__":
    cli()
