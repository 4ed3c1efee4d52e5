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
  - the reverse kernels per call on iteration 1's operands, at the train
    shape (N=2) and the native train step's 1x16x480x854, beside their
    library calls: lista3d_syn_adjoint as a middle iteration runs it (with
    a base, alpha -1) beside F.conv3d, and lista3d_wgrad dense and with the
    phase-row mask the reverse loop passes ("masked", where the checkout
    has one) beside torch.nn.grad.conv3d_weight; each over calls launched
    one by one ("ms") and replayed from a CUDA graph ("graph ms": the
    device's time alone);
  - one flagship train step (N=2 clips of 16x128x128, forward, backward,
    clipped Adam, projection; host clock), and the native one (a clean
    1x16x480x854 clip through make_train_step, its noise drawn on the card);
    for each also the host's time to issue it ("host ms": the host clock
    until the step returns, unsynchronized) and the device's busy time in a
    torch.profiler trace of one step ("device ms": its kernels' summed
    times).

--reverse times only the reverse kernels and the train steps.

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


def graph_ms(fn, rounds, reps):
    """Per-call device ms of fn, for each of `rounds` rounds: `reps` calls
    captured in one CUDA graph and replayed between CUDA events, so that the
    host's cost of a launch drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # outside the capture: the kernels build, the wrappers warm up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return out


def issue_ms(fn, rounds):
    """Host ms to issue one call of fn, for each of `rounds` rounds: the host
    clock from a synchronized device until fn returns."""
    import torch

    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return out


def kernel_ms(fn):
    """{device-side event name: summed ms} of one call of fn in a
    torch.profiler trace: its kernels, copies and fills (the host operators'
    device totals, which count the same kernels again, are left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            out[ev.name] = out.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return out



def step_times(record, key, fn, rounds):
    """Records a train step's host-clock ms (synchronized), its host issue
    ms (issue_ms) and its device busy ms: the summed device time of one
    step's kernels (kernel_ms), where the trace holds any."""
    record(f"{key} ms", rounds_ms(fn, rounds, warmup=1, events=False))
    record(f"{key} host ms", issue_ms(fn, rounds))
    busy = sum(kernel_ms(fn).values())
    if busy > 0:
        record(f"{key} device ms", [busy])


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
    p.add_argument("--reverse", action="store_true",
                   help="time only the reverse kernels and the train steps")
    a = p.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_video_serve: needs a GPU", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from cdlnet_tpu_torch.core.preprocess import pre_process_3d
    from cdlnet_tpu_torch.kernels import _build
    from cdlnet_tpu_torch.kernels import lista3d as L
    from cdlnet_tpu_torch.kernels import lista3d_bwd as LB
    from cdlnet_tpu_torch.models import CDLNetVideo
    from cdlnet_tpu_torch.ops import polyphase as pp
    from cdlnet_tpu_torch.serve import Denoiser
    from cdlnet_tpu_torch.train.fit import make_train_step, train_update
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

    def reverse(name, m, y, sigma, reps):
        """Records the reverse kernels' ms per call (eager and graph) on
        iteration 1's operands of clip(s) y, beside their library calls."""
        yp, _, _ = pre_process_3d(y, s)
        y2, _, wa, ws, tau, geom = L.phase_operands(yp, m.A, m.B, m.t, sigma / 255, s)
        z0 = L.lista3d_ana_threshold(-y2, None, wa[0], tau[0], geom)
        r1 = L.lista3d_syn_residual(z0, ws[1], geom, y=y2)
        ws_adj, taps = LB.adjoint_bank(ws[1]), tuple(wa.shape[2:5])
        r_full = pp.depth_to_space(r1, s, 3, m.A.shape[2])
        forms = {"": {}}
        if hasattr(LB, "phase_rows"):
            forms[" masked"] = {"rows": LB.phase_rows(geom, wa.shape[1], 3)}
        calls = {
            "lista3d_syn_adjoint": lambda: LB.lista3d_syn_adjoint(r1, ws_adj, z0, geom, base=z0,
                                                                  alpha=-1.0),
            "lista3d_syn_adjoint library": lambda: F.conv3d(r_full, m.B[1], stride=s,
                                                            padding=geom.pads),
            "lista3d_wgrad library": lambda: torch.nn.grad.conv3d_weight(
                r_full, m.A[1].shape, z0, stride=s, padding=geom.pads),
            **{f"lista3d_wgrad{form}": (lambda kw=kw: LB.lista3d_wgrad(
                r1, z0, taps, geom.off_a, alpha=-1.0, **kw)) for form, kw in forms.items()},
        }
        for key, fn in calls.items():
            record(f"{name} {key} ms", rounds_ms(fn, a.rounds, reps))
            record(f"{name} {key} graph ms", graph_ms(fn, a.rounds, reps))
        if hasattr(LB, "wgrad_grid"):
            N, Cp, *grid = r1.shape
            res[f"{name} grids"] = {
                f"lista3d_wgrad{form}": LB.wgrad_grid(N, Cp, z0.shape[1], grid, taps, **kw)
                for form, kw in forms.items()}
        # each call's kernels, as a trace times them
        res[f"{name} kernels"] = {key: {k: round(v, 4) for k, v in kernel_ms(fn).items()}
                                  for key, fn in calls.items() if "library" not in key}

    def noisy(shape):
        clean = smooth(rng, shape[0], shape[1:])
        return clean + SIGMA / 255 * rng.standard_normal(clean.shape).astype(np.float32)

    def dev_clip(clip):
        return torch.from_numpy(np.ascontiguousarray(clip))[None, None].to(dev)

    clips = {name: noisy(shape) for name, shape in (("serve", CLIP), ("native", NATIVE))}
    with torch.inference_mode():
        train_y = torch.from_numpy(np.stack([noisy(CLIP)[None] for _ in range(TRAIN_N)])).to(dev)
        train_sigma = torch.tensor([20.0, 30.0], device=dev)
        reverse("train", model, train_y, train_sigma, 10)
        reverse("native step", model, dev_clip(clips["native"]), SIGMA, 2)
        torch.cuda.empty_cache()
    if a.reverse:
        del mri
    with torch.inference_mode():
        if a.reverse:
            clips = {}
        else:
            pair("train", model, train_y, train_sigma, 20)
            pair("240x432", model, dev_clip(clips["native"][:, :HALF_NATIVE[1],
                                                            :HALF_NATIVE[2]]), SIGMA, 5)
            pair("native step", model, dev_clip(clips["native"]), SIGMA, 3)
            pair("mri (9,9,5)", mri, dev_clip(noisy(MRI_VOLUME)), SIGMA, 5)
            del mri
        del train_y
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
    step_times(record, "train step",
               lambda: train_update(model, opt, state, noisy_t, sig_t, clean_t), a.rounds)
    del clean_t, noisy_t, sig_t
    # the native step, as fit() runs it: a clean clip, noise drawn on the card
    native_step, _ = make_train_step(model, opt, workload="3d", noise_std=(20.0, 30.0))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    native_clean = torch.from_numpy(smooth(rng, NATIVE[0], NATIVE[1:])[None, None]).to(dev)
    torch.cuda.empty_cache()
    step_times(record, "native step", lambda: native_step(state, native_clean, gen),
               max(2, a.rounds // 2))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
