#!/usr/bin/env python3
"""Time the flagship 2D image path of one checkout on the GPU.

    python3 cdlnet_tpu_torch/tools/bench_image_serve.py [--root DIR] [--label NAME]

At the flagship 2D width (CDLNet K=30, M=169, P=7, s=2, adaptive; the
power-method init from a seed, thresholds drawn as chip_smoke.py draws
them) it times, on the kernels:

  - the forward pair lista2d_ana_threshold / lista2d_syn_residual per call
    on iteration 1's operands, beside the one strided PyTorch call of the
    same correlation (F.conv2d / F.conv_transpose2d, cuDNN in fp32): one
    128^2 image (the serve shape), ten (the train shape) and 512^2; the
    synthesis also as the 2D reverse pass's analysis adjoint (A's flipped
    bank, with a mask) at the train shape, and at the CSR models' P=9 taps
    on a 640x384 frame and on a 128^2 image. Each is timed twice with CUDA
    events: over calls launched one after another from Python ("ms", as
    chip_smoke.py times them, where a small call's time is the host's), and
    over the same calls captured in a CUDA graph and replayed ("graph ms":
    the device's time alone). At one 128^2 image and at the train shape the
    synthesis is also timed on codes 4 bytes off the 16-byte grid ("off-grid
    z": the staging path of history slices and ragged widths), and at one
    128^2 image each wrapper's and library call's host cost is read ("host
    us": the host clock over calls launched back to back), and each kernel's
    C entry's alone ("entry host us": the ctypes call with its arguments
    made beforehand, which the wrapper's Python checks surround);
  - one K=30 forward (CUDA events, five a round) at 128^2 and at 481x321
    (bucketed to 512x384), with the plain cuDNN loop (backend "xla") beside
    it, and at 128^2 the host's time to launch one ("host ms");
  - Denoiser.denoise_image (host clock, five a round) at both sizes, and
    denoise_image_batch of 8 images at 128^2;
  - the 2D reverse kernels per call on iteration 1's operands at the train
    shape (10 x 128^2) and at the CSR models' P=9 taps on a 640x384 frame,
    beside their library calls: lista2d_syn_adjoint as a middle iteration
    runs it (a base, alpha -1) beside F.conv2d, and lista2d_wgrad dense and
    with the phase-row mask the reverse loop passes ("masked", where the
    checkout has one) beside torch.nn.grad.conv2d_weight, eager and graph;
  - one flagship 2D train step (10 crops of 128^2, a sigma each in
    [20, 30]; forward, backward, clipped Adam, projection; host clock, over
    HOST_ROUNDS rounds), with the host's time to issue it ("host ms") and
    the device's busy time in a torch.profiler trace of one step ("device
    ms").

--reverse times only the reverse kernels and the train step.

Where the checkout reports it (kernels.lista2d.launch_grid), it also records
each kernel's launch grid at one 128^2 image. It prints the card's
nvidia-smi name and power limit and then one JSON line with every median
and every round's reading; the host-bound readings at 128^2 (host costs,
the forward, denoise_image) take HOST_ROUNDS rounds and also record their
fastest ("min"), which the host's other load can only slow. --root is the checkout whose cdlnet_tpu_torch is
imported (by default the one that holds this script). Two commits compare
by running the script once per checkout in turns (A B B A ...) on one card:
the kernels build into each checkout's own build directory.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from bench_video_serve import (  # noqa: E402
    bucketed,
    graph_ms,
    kernel_ms,
    rounds_ms,
    smooth,
    step_times,
)

SIGMA = 25.0
SEED = 0
FLAGSHIP_2D = dict(K=30, M=169, P=7, s=2, C=1, adaptive=True)
# the CSR models' taps; iteration 1's banks are all the kernels read
P9 = dict(FLAGSHIP_2D, K=2, P=9)
IMAGE, BIG_IMAGE, P9_FRAME = (128, 128), (321, 481), (640, 384)
TRAIN_N, BATCH = 10, 8
FWD_REPS = 5  # forwards and served images a round
HOST_ROUNDS = 20  # rounds of a host-bound reading


def host_us(fn, rounds, reps):
    """Host us to launch one call of fn, for each of `rounds` rounds: `reps`
    calls back to back on the host clock, the device synchronized before the
    round and after the clock stops. The calls queue while the device works
    (a round stays far below the launch queue's depth), so where fn does
    not wait for the device this is its host cost alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append(1e6 * (time.perf_counter() - t0) / reps)
        torch.cuda.synchronize()
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    p.add_argument("--label", default="")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--reverse", action="store_true",
                   help="time only the reverse kernels and the train step")
    a = p.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_image_serve: needs a GPU", file=sys.stderr)
        return 1
    from cdlnet_tpu_torch.core.preprocess import pre_process
    from cdlnet_tpu_torch.kernels import _build
    from cdlnet_tpu_torch.kernels import lista2d as L2
    from cdlnet_tpu_torch.kernels import lista2d_bwd as LB2
    from cdlnet_tpu_torch.kernels import lista3d_bwd as LB
    from cdlnet_tpu_torch.models import CDLNet
    from cdlnet_tpu_torch.ops import polyphase as pp
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
    s = FLAGSHIP_2D["s"]

    def init(cfg, seed):
        m = CDLNet(**cfg, backend="pallas").to(dev).init(torch.Generator().manual_seed(seed))
        tg = torch.Generator().manual_seed(SEED + 2)
        with torch.no_grad():
            m.t.copy_(torch.rand(m.t.shape, generator=tg)
                      * torch.tensor([0.02, 0.2]).reshape(1, 2, 1, 1, 1))
        return m

    model, p9 = init(FLAGSHIP_2D, SEED), init(P9, SEED + 3)
    plain = CDLNet(**FLAGSHIP_2D, backend="xla").to(dev)
    plain.load_state_dict(model.state_dict())
    rng = np.random.default_rng(SEED)
    res = {"label": a.label, "card": card, "rounds": {}}

    def record(key, vals, low=False):
        res["rounds"][key] = [round(v, 4) for v in vals]
        res[key] = round(statistics.median(vals), 4)
        if low:
            res[f"{key} min"] = round(min(vals), 4)

    def noisy(n, size):
        clean = smooth(rng, n, size)
        return clean + SIGMA / 255 * rng.standard_normal(clean.shape).astype(np.float32)

    def images(n, size):
        return torch.from_numpy(noisy(n, size)[:, None]).to(dev)  # (n, 1, H, W)

    def timed(key, fn, reps, host=False):
        record(f"{key} ms", rounds_ms(fn, a.rounds, reps))
        record(f"{key} graph ms", graph_ms(fn, a.rounds, reps))
        if host:
            record(f"{key} host us", host_us(fn, HOST_ROUNDS, reps), low=True)

    def pair(name, m, y, reps, adjoint=False, grid=False, off_grid=False, host=False):
        """Records both kernels' ms per call on iteration 1's operands of
        the images y (N, 1, H, W), and their library calls'; with `adjoint`
        also the synthesis as the analysis adjoint (A's flipped bank, a
        mask), with `grid` each kernel's launch grid, with `off_grid` the
        synthesis on codes off the 16-byte grid, with `host` every call's
        host us."""
        yp, _, _ = pre_process(y, s)
        y2, _, wa, ws, tau, geom = L2.phase_operands(yp, m.A, m.B, m.t, SIGMA / 255, s)
        z0 = L2.lista2d_ana_threshold(-y2, None, wa[0], tau[0], geom)
        r1 = L2.lista2d_syn_residual(z0, ws[1], geom, y=y2)
        r_full = pp.depth_to_space(r1, s, 2, 1)
        pad = m.pad
        timed(f"{name} lista2d_ana_threshold",
              lambda: L2.lista2d_ana_threshold(r1, z0, wa[1], tau[1], geom), reps, host)
        timed(f"{name} lista2d_ana_threshold library",
              lambda: F.conv2d(r_full, m.A[1], stride=s, padding=pad), reps, host)
        timed(f"{name} lista2d_syn_residual",
              lambda: L2.lista2d_syn_residual(z0, ws[1], geom, y=y2), reps, host)
        timed(f"{name} lista2d_syn_residual library",
              lambda: F.conv_transpose2d(z0, m.B[1], stride=s, padding=pad,
                                         output_padding=s - 1), reps, host)
        if host:
            lib = _build.library()
            (N, Cp, H, W), M, (Qh, Qw) = y2.shape, wa.shape[-1], wa.shape[2:4]
            out_a, out_s = torch.empty_like(z0), torch.empty_like(y2)
            stream = torch.cuda.current_stream().cuda_stream
            wa1, tau1, ws1 = wa[1], tau[1], ws[1]
            entries = {
                "lista2d_ana_threshold": (
                    r1.data_ptr(), wa1.data_ptr(), z0.data_ptr(), tau1.data_ptr(),
                    out_a.data_ptr(), N, Cp, M, H, W, Qh, Qw, *geom.off_a, geom.s, *geom.P,
                    *geom.pads, stream),
                "lista2d_syn_residual": (
                    z0.data_ptr(), ws1.data_ptr(), None, y2.data_ptr(), out_s.data_ptr(), N, M,
                    Cp, H, W, Qh, Qw, *geom.off_s, stream)}
            for entry, args in entries.items():
                fn = getattr(lib, entry)
                if fn(*args) != 0:
                    raise RuntimeError(f"{entry} failed to launch")
                record(f"{name} {entry} entry host us",
                       host_us(lambda f=fn, x=args: f(*x), HOST_ROUNDS, reps), low=True)
        if off_grid:
            z_off = torch.empty(z0.numel() + 1, device=dev)[1:].view(z0.shape).copy_(z0)
            timed(f"{name} lista2d_syn_residual off-grid z",
                  lambda: L2.lista2d_syn_residual(z_off, ws[1], geom, y=y2), reps)
        if adjoint:
            wa_adj = LB.adjoint_bank(wa, 2)
            m2 = (torch.rand(y2.shape, generator=torch.Generator().manual_seed(SEED))
                  > 0.3).float().to(dev)
            timed(f"{name} lista2d_syn_residual A-adjoint",
                  lambda: L2.lista2d_syn_residual(z0, wa_adj[1], geom, mask=m2), reps)
        if grid and hasattr(L2, "launch_grid"):
            (N, Cp, H, W), M, (Qh, Qw) = y2.shape, wa.shape[-1], wa.shape[2:4]
            res[f"{name} grids"] = {
                "lista2d_ana_threshold": L2.launch_grid(False, N, Cp, M, H, W, Qh, Qw),
                "lista2d_syn_residual": L2.launch_grid(True, N, M, Cp, H, W, Qh, Qw)}

    # the flagship 2D train step, first: host-bound, it is timed before the
    # other readings fill the process
    tc = smooth(rng, TRAIN_N, IMAGE)[:, None]
    sig = rng.uniform(20, 30, (TRAIN_N, 1, 1, 1)).astype(np.float32)
    tn = tc + sig / 255 * rng.standard_normal(tc.shape).astype(np.float32)
    clean_t, noisy_t, sig_t = (torch.from_numpy(v).to(dev) for v in (tc, tn, sig))
    opt = make_optimizer(1e-3, clip_grad=0.05)
    state = opt.init(dict(model.named_parameters()))
    # host-bound: HOST_ROUNDS rounds, with the fastest
    step_times(lambda key, vals: record(key, vals, low=True), "train step",
               lambda: train_update(model, opt, state, noisy_t, sig_t, clean_t), HOST_ROUNDS)

    def reverse(name, m, y, reps):
        """Records the 2D reverse kernels' ms per call (eager and graph) on
        iteration 1's operands of the images y, beside their library
        calls."""
        yp, _, _ = pre_process(y, s)
        y2, _, wa, ws, tau, geom = L2.phase_operands(yp, m.A, m.B, m.t, SIGMA / 255, s)
        z0 = L2.lista2d_ana_threshold(-y2, None, wa[0], tau[0], geom)
        r1 = L2.lista2d_syn_residual(z0, ws[1], geom, y=y2)
        ws_adj, taps = LB.adjoint_bank(ws[1], 2), tuple(wa.shape[2:4])
        r_full = pp.depth_to_space(r1, s, 2, 1)
        forms = {"": {}}
        if hasattr(LB, "phase_rows"):
            forms[" masked"] = {"rows": LB.phase_rows(geom, wa.shape[1], 2)}
        calls = {
            "lista2d_syn_adjoint": lambda: LB2.lista2d_syn_adjoint(r1, ws_adj, z0, geom,
                                                                   base=z0, alpha=-1.0),
            "lista2d_syn_adjoint library": lambda: F.conv2d(r_full, m.B[1], stride=s,
                                                            padding=m.pad),
            "lista2d_wgrad library": lambda: torch.nn.grad.conv2d_weight(
                r_full, m.A[1].shape, z0, stride=s, padding=m.pad),
            **{f"lista2d_wgrad{form}": (lambda kw=kw: LB2.lista2d_wgrad(
                r1, z0, taps, geom.off_a, alpha=-1.0, **kw)) for form, kw in forms.items()},
        }
        for key, fn in calls.items():
            record(f"{name} {key} ms", rounds_ms(fn, a.rounds, reps))
            record(f"{name} {key} graph ms", graph_ms(fn, a.rounds, reps))
        if hasattr(LB, "wgrad_grid"):
            N, Cp, *grid = r1.shape
            res[f"{name} grids"] = {
                f"lista2d_wgrad{form}": LB.wgrad_grid(N, Cp, z0.shape[1], grid, taps, **kw)
                for form, kw in forms.items()}
            res[f"{name} grids"]["lista2d_syn_adjoint"] = L2.launch_grid(
                False, N, Cp, z0.shape[1], *grid, *taps)
        # each call's kernels, as a trace times them
        res[f"{name} kernels"] = {key: {k: round(v, 4) for k, v in kernel_ms(fn).items()}
                                  for key, fn in calls.items() if "library" not in key}

    with torch.inference_mode():
        reverse("train", model, images(TRAIN_N, IMAGE), 20)
        reverse("P=9 640x384", p9, images(1, P9_FRAME), 10)

    def serve():
        """The forward pair, the K=30 forwards and the served images."""
        with torch.inference_mode():
            pair("serve", model, images(1, IMAGE), 20, grid=True, off_grid=True, host=True)
            pair("train", model, images(TRAIN_N, IMAGE), 20, adjoint=True, off_grid=True)
            pair("512^2", model, images(1, (512, 512)), 10)
            pair("P=9 640x384", p9, images(1, P9_FRAME), 10)
            pair("P=9 128^2", p9, images(1, IMAGE), 20)
            # the K=30 forward at the bucket the Denoiser runs, on the kernels
            # and on the cuDNN loop
            served = {"128^2": noisy(1, IMAGE), "481x321": noisy(1, BIG_IMAGE)}
            for name, img in served.items():
                y = torch.from_numpy(bucketed(img)[:, None]).to(dev)
                n_rounds = HOST_ROUNDS if name == "128^2" else a.rounds
                record(f"{name} K=30 forward ms", rounds_ms(lambda: model(y, SIGMA), n_rounds,
                                                            FWD_REPS), low=True)
                record(f"{name} K=30 forward xla ms", rounds_ms(lambda: plain(y, SIGMA), a.rounds,
                                                                FWD_REPS))
                if name == "128^2":
                    record(f"{name} K=30 forward host ms",
                           [v / 1e3 for v in host_us(lambda: model(y, SIGMA), HOST_ROUNDS,
                                                     FWD_REPS)], low=True)
        server = Denoiser(model)
        for name, img in served.items():
            record(f"{name} denoise_image ms", rounds_ms(
                lambda: server.denoise_image(img[0], sigma=SIGMA),
                HOST_ROUNDS if name == "128^2" else a.rounds, FWD_REPS, warmup=1, events=False),
                low=True)
        batch = noisy(BATCH, IMAGE)
        record(f"denoise_image_batch of {BATCH} ms", rounds_ms(
            lambda: server.denoise_image_batch(batch, sigmas=SIGMA), a.rounds, warmup=1,
            events=False))

    if not a.reverse:
        serve()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
