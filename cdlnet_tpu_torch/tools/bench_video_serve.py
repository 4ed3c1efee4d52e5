#!/usr/bin/env python3
"""Time the flagship video path of one checkout on the GPU.

    python3 cdlnet_tpu_torch/tools/bench_video_serve.py [--root DIR] [--label NAME]

At the flagship video width (CDLNetVideo K=30, M=169, P=(7,7,5), s=2,
adaptive; the power-method init from a seed, thresholds drawn as
chip_smoke.py draws them) it times, on the kernels:

  - the forward pair lista3d_ana_threshold / lista3d_syn_residual per call
    (CUDA events), on iteration 1's operands, at the shapes chip_smoke.py
    times them: the serve shape (one 16x128x128 clip), the train shape (two
    such clips, a sigma each), the native shape (16x480x854, bucketed to
    512x896), 16x240x432, the native train step's 1x16x480x854 (a 427-wide
    code grid) and the fastMRI config's P=(9,9,5) taps at 30x320x192;
  - one K=30 forward (CUDA events) of a 16x128x128 clip and of a native
    clip, with the plain cuDNN loop (backend "xla") beside them;
  - Denoiser.denoise_video (host clock) of both clips at a known sigma;
  - one flagship train step (N=2 clips of 16x128x128, forward, backward,
    clipped Adam, projection; host clock).

It prints the card's nvidia-smi name and power limit and then one JSON line
with every median and every round's reading. --root is the checkout whose
cdlnet_tpu_torch is imported (by default the one that holds this script).
Two commits compare by running the script once per checkout in turns
(A B B A ...) on one card: the kernels build into each checkout's own
build directory.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SIGMA = 25.0
SEED = 0
FLAGSHIP = dict(K=30, M=169, P=(7, 7, 5), s=2, C=1, adaptive=True, depth=16)
# the fastMRI config's taps; iteration 1's banks are all the kernels read
MRI = dict(FLAGSHIP, K=2, P=(9, 9, 5), depth=30)
CLIP, NATIVE = (16, 128, 128), (16, 480, 854)
HALF_NATIVE, MRI_VOLUME = (16, 240, 432), (30, 320, 192)
TRAIN_N = 2


def rounds_ms(fn, rounds, reps=1, warmup=2, events=True):
    """Per-call ms of `reps` calls of fn, for each of `rounds` rounds: CUDA
    events, or the host clock followed by a device synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        if events:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0) / reps)
    return out


def smooth(rng, depth, size, n_terms=6):
    """Smooth random frames in [0, 1] (depth, H, W), as chip_smoke.py's."""
    import numpy as np

    H, W = size
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    out = np.zeros((depth, H, W), np.float32)
    for d in range(depth):
        for _ in range(n_terms):
            fy, fx, ph = rng.uniform(0.5, 4, 2).tolist() + [rng.uniform(0, 6.3)]
            out[d] += np.cos(2 * np.pi * (fy * yy + fx * xx) + ph).astype(np.float32)
    out -= out.min(axis=(1, 2), keepdims=True)
    return out / out.max(axis=(1, 2), keepdims=True)


def bucketed(clip):
    """A (D, H, W) clip reflect-padded to the Denoiser's 64-pixel buckets."""
    import numpy as np

    pads = [(0, 0)] + [(0, -(-n // 64) * 64 - n) for n in clip.shape[1:]]
    return np.pad(clip, pads, mode="reflect")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    p.add_argument("--label", default="")
    p.add_argument("--rounds", type=int, default=5)
    a = p.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_video_serve: needs a GPU", file=sys.stderr)
        return 1
    from cdlnet_tpu_torch.core.preprocess import pre_process_3d
    from cdlnet_tpu_torch.kernels import _build
    from cdlnet_tpu_torch.kernels import lista3d as L
    from cdlnet_tpu_torch.models import CDLNetVideo
    from cdlnet_tpu_torch.serve import Denoiser
    from cdlnet_tpu_torch.train.fit import train_update
    from cdlnet_tpu_torch.train.optim import make_optimizer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda")
    K, M, s = FLAGSHIP["K"], FLAGSHIP["M"], FLAGSHIP["s"]
    model = CDLNetVideo(**FLAGSHIP, backend="pallas").to(dev)
    model.init(torch.Generator().manual_seed(SEED))
    tg = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        model.t.copy_((torch.rand(K, 2, M, 1, 1, 1, generator=tg)
                       * torch.tensor([0.02, 0.2]).reshape(1, 2, 1, 1, 1, 1)).to(dev))
    plain = CDLNetVideo(**FLAGSHIP, backend="xla").to(dev)
    plain.load_state_dict(model.state_dict())
    mri = CDLNetVideo(**MRI, backend="pallas").to(dev)
    mri.init(torch.Generator().manual_seed(SEED + 3))
    with torch.no_grad():
        mri.t.copy_(model.t[:MRI["K"]])
    rng = np.random.default_rng(SEED)
    res = {"label": a.label, "card": card, "rounds": {}}

    def record(key, vals):
        res["rounds"][key] = [round(v, 4) for v in vals]
        res[key] = round(statistics.median(vals), 4)

    def pair(name, m, y, sigma, reps, off_grid=False):
        """Records both kernels' ms per call on iteration 1's operands of
        clip(s) y (N, 1, D, H, W) at noise level(s) sigma; with `off_grid`
        also the synthesis on the same codes 4 bytes off the 16-byte grid,
        which takes its staging path for rows at different offsets."""
        yp, _, _ = pre_process_3d(y, s)
        y2, _, wa, ws, tau, geom = L.phase_operands(yp, m.A, m.B, m.t, sigma / 255, s)
        z0 = L.lista3d_ana_threshold(-y2, None, wa[0], tau[0], geom)
        r1 = L.lista3d_syn_residual(z0, ws[1], geom, y=y2)
        record(f"{name} lista3d_ana_threshold ms", rounds_ms(
            lambda: L.lista3d_ana_threshold(r1, z0, wa[1], tau[1], geom), a.rounds, reps))
        record(f"{name} lista3d_syn_residual ms", rounds_ms(
            lambda: L.lista3d_syn_residual(z0, ws[1], geom, y=y2), a.rounds, reps))
        if off_grid:
            z_off = torch.empty(z0.numel() + 1, device=dev)[1:].view(z0.shape).copy_(z0)
            record(f"{name} lista3d_syn_residual off-grid z ms", rounds_ms(
                lambda: L.lista3d_syn_residual(z_off, ws[1], geom, y=y2), a.rounds, reps))

    def noisy(shape):
        clean = smooth(rng, shape[0], shape[1:])
        return clean + SIGMA / 255 * rng.standard_normal(clean.shape).astype(np.float32)

    def dev_clip(clip):
        return torch.from_numpy(np.ascontiguousarray(clip))[None, None].to(dev)

    clips = {name: noisy(shape) for name, shape in (("serve", CLIP), ("native", NATIVE))}
    with torch.inference_mode():
        train_y = torch.from_numpy(np.stack([noisy(CLIP)[None] for _ in range(TRAIN_N)])).to(dev)
        train_sigma = torch.tensor([20.0, 30.0], device=dev)
        pair("train", model, train_y, train_sigma, 20)
        pair("240x432", model, dev_clip(clips["native"][:, :HALF_NATIVE[1], :HALF_NATIVE[2]]),
             SIGMA, 5)
        pair("native step", model, dev_clip(clips["native"]), SIGMA, 3)
        pair("mri (9,9,5)", mri, dev_clip(noisy(MRI_VOLUME)), SIGMA, 5)
        del train_y, mri
        for name, clip in clips.items():
            y = dev_clip(bucketed(clip))
            pair(name, model, y, SIGMA, 20 if name == "serve" else 3, off_grid=True)
            # the K=30 forward, on the kernels and on the cuDNN loop
            record(f"{name} K=30 forward ms", rounds_ms(lambda: model(y, SIGMA), a.rounds))
            record(f"{name} K=30 forward xla ms", rounds_ms(lambda: plain(y, SIGMA), a.rounds))
            del y
            torch.cuda.empty_cache()
    server = Denoiser(model)
    for name, clip in clips.items():
        record(f"{name} denoise_video ms", rounds_ms(
            lambda: server.denoise_video(clip, sigma=SIGMA), a.rounds, warmup=1, events=False))
    # the flagship train step
    tc = np.stack([smooth(rng, *CLIP[:1], CLIP[1:])[None] for _ in range(TRAIN_N)])
    sig = rng.uniform(20, 30, (TRAIN_N, 1, 1, 1, 1)).astype(np.float32)
    tn = tc + sig / 255 * rng.standard_normal(tc.shape).astype(np.float32)
    clean_t, noisy_t, sig_t = (torch.from_numpy(v).to(dev) for v in (tc, tn, sig))
    opt = make_optimizer(2e-4, clip_grad=0.05)
    state = opt.init(dict(model.named_parameters()))
    record("train step ms", rounds_ms(
        lambda: train_update(model, opt, state, noisy_t, sig_t, clean_t), a.rounds,
        warmup=1, events=False))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
