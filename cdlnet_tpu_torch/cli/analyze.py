#!/usr/bin/env python3
"""Analysis CLI for the 2D models: `python -m cdlnet_tpu_torch.cli.analyze
args.json [flags]` (counterpart of cdlnet_tpu/cli/analyze.py), for CDLNet
(and JDD), GDLNet, DnCNN and FFDNet on the card unless main() is given
device="cpu".

  --test DIR            image PSNR sweep over the --noise_level values;
                        "sigma, PSNR" lines appended to
                        {save_dir}/test_{dset}_{blind}.txt, an eval row to
                        metrics.jsonl, and with --save noisy/output PNGs
  --dictionary          the synthesis dictionary D = B[0] and its FFT
                        magnitude response
  --passthrough IMG     one image with per-iteration sparse-code dumps
                        (apply_with_codes)
  --thresholds          tau heatmap over (iteration, subband); needs matplotlib
  --filters             A/B filter grids per iteration
  --blind MAD|PCA       blind noise-level estimation (nle.noise_level), per
                        image
  --noise_level N [N..] input noise sigma(s) on [0, 255]
  --save, --save_dir, --color, --demosaic, --backend

The files it writes have the JAX CLI's names and formats. The noise comes
from a torch.Generator seeded 0 per noise level, so the PSNRs are not the
JAX CLI's digit for digit. The video and fastMRI analyzers,
cli/analyze3d.py and cli/analyzemri.py, share the parser and these
commands. DnCNN and FFDNet run in eval() mode on their checkpointed
BatchNorm statistics; FFDNet takes the known or blind sigma into its noise
map (the JAX CLI gives it none), DnCNN none. They have no dictionary or
filters: those commands raise for them, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import os
from pprint import pprint

import numpy as np
import torch

from cdlnet_tpu_torch import nle
from cdlnet_tpu_torch.cli import train as cli_train
from cdlnet_tpu_torch.data.noise import awgn, gen_bayer_mask
from cdlnet_tpu_torch.utils import (
    append_metric,
    img_load,
    img_save,
    make_grid,
    psnr,
    setup_debug,
)

def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument("args_fn", type=str, help="Path to args.json file.")
    p.add_argument("--test", type=str, default=None)
    p.add_argument("--dictionary", action="store_true")
    p.add_argument("--passthrough", type=str, default=None)
    p.add_argument("--noise_level", type=int, nargs="*", default=[-1])
    p.add_argument("--blind", type=str, default=None, choices=["MAD", "PCA"])
    p.add_argument("--save", action="store_true")
    p.add_argument("--thresholds", action="store_true")
    p.add_argument("--filters", action="store_true")
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--color", action="store_true")
    p.add_argument("--demosaic", action="store_true")
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "pallas", "cuda", "xla"],
                   help="'auto' keeps a backend the config pins, else the "
                        "hand-written kernels; 'xla' is the plain PyTorch loop.")
    return p


def resolve_noise_levels(ARGS, model_args):
    """The --noise_level values; -1 (the default) takes the config's
    train.fit.noise_std."""
    nl = ARGS.noise_level
    if len(nl) == 1:
        nl = nl[0]
    if nl == -1:
        nl = model_args["train"]["fit"]["noise_std"]
    if not isinstance(nl, (range, list, tuple)):
        nl = [nl]
    return nl


def get_filters_for(model):
    """The stacked (K, M, C, P, P) analysis and synthesis banks as numpy:
    GDLNet's synthesized from its Gabor parameters, else A and B (CDLNet,
    and the CSR models' primary banks)."""
    if hasattr(model, "get_filters"):
        banks = model.get_filters()
    elif hasattr(model, "A") and hasattr(model, "B"):
        banks = (model.A, model.B)
    else:
        raise NotImplementedError(type(model).__name__)
    return tuple(b.detach().cpu().numpy() for b in banks)


def _sigma(model, y, sigma, blind):
    """The sigma the model takes: None unless adaptive; the known sigma, or
    with `blind` 255 * the estimate per image (N,)."""
    if not model.adaptive:
        return None
    if blind:
        return 255.0 * nle.noise_level(y, method=blind)
    return float(sigma)


@torch.inference_mode()
def test(model, loader, noise_levels, blind, save_dir, save, demosaic):
    # dataset name = the test dir itself (the reference's
    # basename(dirname(img_path)), img_path a file inside the dir)
    dset = os.path.basename(os.path.normpath(loader.dataset.root_dirs[0]))
    fn = os.path.join(save_dir, f"test_{dset}_{blind}.txt")
    if save:
        os.makedirs(os.path.join(save_dir, "test_noise"), exist_ok=True)
        os.makedirs(os.path.join(save_dir, "test_output"), exist_ok=True)
    dev = next(model.parameters()).device

    for sigma in noise_levels:
        total, count = 0.0, 0
        gen = torch.Generator(device=dev).manual_seed(0)
        for x in loader:
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)  # (N, C, H, W)
            mask = gen_bayer_mask(x) if demosaic else None
            y, _ = awgn(x, float(sigma), gen)
            if mask is not None:
                y = mask * y
            xhat = model(y, _sigma(model, y, sigma, blind), mask=mask)[0]
            x_np, y_np, xhat_np = (v.cpu().numpy() for v in (x, y, xhat))
            total += psnr(x_np, xhat_np)
            count += 1
            if save:
                img_save(os.path.join(save_dir, "test_noise", f"noise_{count:05d}.png"), y_np)
                img_save(os.path.join(save_dir, "test_output", f"output_{count:05d}.png"),
                         xhat_np)
        avg = total / max(count, 1)
        print(f"sigma={sigma}: PSNR = {avg:.3f}")
        with open(fn, "a") as f:
            f.write(f"{sigma}, {avg:.3f}\n")
        append_metric(save_dir, event="eval", dataset=dset, blind=str(blind),
                      sigma=float(sigma), psnr=avg, images=count)
    print(f"saved to file {fn}")


def thresholds(model, save_dir, noise_level=25):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = 1 if model.adaptive else 0
    t = model.t.detach().cpu().numpy()  # (K, 2, M, 1, 1)
    tau = (t[:, 0] + c * (noise_level / 255.0) * t[:, 1])[:, :, 0, 0]
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
    A, B = get_filters_for(model)
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
    img_save(os.path.join(out_dir, f"D{A.shape[0] - 1:02d}_{scale_each}.png"),
             make_grid(B[0], nrow=n, normalize_each=True))
    print(f"saved filter grids to {out_dir}")


def dictionary(model, save_dir):
    D = get_filters_for(model)[1][0]  # (M, C, P, P)
    n = int(np.ceil(np.sqrt(D.shape[0])))
    img_save(os.path.join(save_dir, "D_learned.png"), make_grid(D, nrow=n, normalize_each=True))
    X = np.fft.fftshift(np.fft.fft2(D, s=(64, 64)), axes=(-2, -1))
    img_save(os.path.join(save_dir, "freq.png"),
             make_grid(np.abs(X).astype(np.float32), nrow=n, padding=10, normalize_each=True))
    print(f"saved D_learned.png, freq.png to {save_dir}")


@torch.inference_mode()
def passthrough(model, img_path, noise_std, save_dir, blind, color, demosaic, save):
    """Denoise one image and dump every iteration's codes with --save, and
    noisy | output | clean side by side. Returns the PSNR."""
    img_name = os.path.splitext(os.path.basename(img_path))[0]
    out_dir = os.path.join(save_dir, f"passthrough_{img_name}")
    os.makedirs(out_dir, exist_ok=True)
    dev = next(model.parameters()).device

    x = torch.from_numpy(img_load(img_path, gray=not color)).to(dev)
    y, _ = awgn(x, float(noise_std), torch.Generator(device=dev).manual_seed(0))
    m = gen_bayer_mask(y) if demosaic else None
    if m is not None:
        y = m * y
    sigma = _sigma(model, y, noise_std, blind)
    if blind and sigma is not None:
        print(f"sigma_hat = {float(sigma.reshape(-1)[0]):.3f}")

    xhat, _, codes = model.apply_with_codes(y, sigma, mask=m)
    n = round(np.sqrt(model.M))
    if save:
        for i in range(codes.shape[0]):
            csc = codes[i, 0].abs().cpu().numpy()[:, None]  # (M, 1, h, w)
            img_save(os.path.join(out_dir, f"csc{i:02d}.png"),
                     make_grid(csc / max(csc.max(), 1e-8), nrow=n, padding=10))
    x, y, xhat = (v.cpu().numpy() for v in (x, y, xhat))
    p = psnr(x, xhat)
    print(f"PSNR = {p:.2f}")
    img_save(os.path.join(out_dir, "compare.png"), np.concatenate([y, xhat, x], axis=3))
    return p


def main(ARGS, model_args, device=None):
    """Run the analyses ARGS asks for on the 2D model model_args describes
    (its checkpoint at paths.ckpt, else the init), on `device`: the card
    when None."""
    from cdlnet_tpu_torch.data.images import get_data_loader
    from cdlnet_tpu_torch.train.fit import init_model

    setup_debug()
    model_args = cli_train.apply_backend(ARGS.backend, model_args)
    model = init_model(model_args, device=device)[0].eval()

    save_dir = ARGS.save_dir or model_args["paths"]["save"]
    os.makedirs(save_dir, exist_ok=True)
    noise_levels = resolve_noise_levels(ARGS, model_args)
    nl0 = noise_levels[0]

    if ARGS.test is not None:
        loader = get_data_loader([ARGS.test], load_color=ARGS.color, test=True)
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
