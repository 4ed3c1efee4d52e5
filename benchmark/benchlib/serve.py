"""Serving cells: a closed loop of one client calling the Denoiser back to
back on a pool of noisy inputs, each request timed from the call to the
numpy result it returns.

Traffic keys: kind ("serve_video": Denoiser.denoise_video on (D, H, W)
clips; "serve_image": denoise_image on (H, W) images), shape (a clip's
(D, H, W) or a landscape image's (H, W)), portrait_share (the share of
images served transposed), pool (inputs made in set-up), sigma (the
noise level the client passes; null: blind, the Denoiser's MAD estimate),
noise_std (the noise in the inputs: a number, or a range [lo, hi] drawn per
input), bucket (the Denoiser's), warmup_s (seconds of calls in set-up, every input
shape in turn), check_requests
(how many finished requests the reference checks, drawn from the seed).
"""

from __future__ import annotations

import gc
import math
import random
import sys
import time

import numpy as np
import torch

import work
from benchlib import program, synth
from benchlib.tracing import Trace, stamp
from reference.lista import bucket_pad, exact_fp32, lista_forward
from reference.mad import mad_sigma


def make_pool(traffic: dict, seed: int, device) -> list:
    """The noisy inputs, as numpy float32 arrays."""
    g = synth.generator(seed, "pool", device)
    lo_hi = traffic["noise_std"]
    shape = tuple(traffic["shape"])
    out = []
    for i in range(traffic["pool"]):
        if len(shape) == 3:
            clean = synth.texture(g, shape[0], *shape[1:], device)
        else:
            hw = shape[::-1] if synth.portrait(traffic.get("portrait_share"), i) else shape
            clean = synth.texture(g, 1, *hw, device)[0]
        if isinstance(lo_hi, list):
            s = float(lo_hi[0] + (lo_hi[1] - lo_hi[0]) * torch.rand(1, generator=g, device=device))
        else:
            s = float(lo_hi)
        out.append(synth.noisy(g, clean, s).cpu().numpy())
    return out


def reference_outputs(config: dict, traffic: dict, seed: int, inputs: list, device,
                      exact: bool = True) -> list:
    """The reference's output for each input (numpy), the weights made
    anew from the seed; exact False computes in TF32, cuDNN's TF32 on and
    every convolution's operands rounded (the control)."""
    W = synth.weights(config["model"], seed, device)
    m = config["model"]
    outs = []
    with exact_fp32(exact), torch.no_grad():
        for y in inputs:
            yt = torch.from_numpy(y).to(device)
            yt = yt.reshape((1, 1) + yt.shape)
            yp = bucket_pad(yt, traffic["bucket"])
            sigma = traffic["sigma"]
            if sigma is None:
                frames = yp if yp.ndim == 4 else yp.transpose(1, 2).reshape(-1, 1, *yp.shape[-2:])
                sigma = 255.0 * mad_sigma(frames, tf32=not exact).mean()
            x = lista_forward(W["A"], W["B"], W["t"], yp, sigma, m["s"], m["adaptive"],
                              tf32=not exact)
            outs.append(x[..., : y.shape[-2], : y.shape[-1]].reshape(y.shape).cpu().numpy())
    return outs


def run(spec: dict, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    config, traffic = spec["config"], spec["traffic"]
    stamp(t0, "imports")
    model = program.build(config, synth.weights(config["model"], seed, device), device)
    den = program.denoiser(model, traffic["bucket"])
    call = den.denoise_video if traffic["kind"] == "serve_video" else den.denoise_image
    stamp(t0, "model and weights")
    inputs = make_pool(traffic, seed, device)
    stamp(t0, "inputs")
    sigma = traffic["sigma"]
    # every input shape, then back-to-back calls for warmup_s seconds, so
    # that the card's clocks have risen before the window as they have in
    # a server under this load
    by_shape = {y.shape: y for y in inputs}
    for y in by_shape.values():
        call(y, sigma=sigma)
    w = time.perf_counter()
    while time.perf_counter() - w < traffic["warmup_s"]:
        for y in by_shape.values():
            call(y, sigma=sigma)
    stamp(t0, "warm-up")

    rng = random.Random(f"{seed}:order")
    order: list = []
    keep_n = traffic["check_requests"]
    kept = []  # (pool index, output): a reservoir sample of the finished requests
    lat, failed, frames, flops, roof = [], 0, 0, 0.0, 0.0
    m = config["model"]
    per_input = {}
    launches0 = program.launches()
    setup_s = time.perf_counter() - t0
    with Trace(trace) as tr:
        w0_ns, w0 = time.time_ns(), time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            if not order:
                order = list(range(len(inputs)))
                rng.shuffle(order)
            i = order.pop()
            y = inputs[i]
            a = time.perf_counter()
            try:
                out = call(y, sigma=sigma)
            except Exception as e:  # a failed request counts and the loop goes on
                failed += 1
                print(f"request failed: {type(e).__name__}: {e}", file=sys.stderr)
                continue
            lat.append(time.perf_counter() - a)
            n = len(lat) - 1
            if n < keep_n:
                kept.append((i, out))
            else:
                j = rng.randrange(n + 1)
                if j < keep_n:
                    kept[j] = (i, out)
            if y.shape not in per_input:
                spatial = y.shape
                per_input[y.shape] = (work.forward_flops(m, spatial),
                                      work.forward_bytes(m, spatial))
            f, b = per_input[y.shape]
            frames += y.shape[0] if y.ndim == 3 else 1
            flops += f
            roof += work.roofline_s(f, b)
        window_s = time.perf_counter() - w0
        w1_ns = time.time_ns()
    summary = tr.summary(w0_ns, w1_ns)
    launches = program.launches() - launches0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    del den, model, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = [out for _, out in kept]
    ref = reference_outputs(config, traffic, seed, [inputs[i] for i, _ in kept], device)
    err = max((float(np.max(np.abs(g - r))) for g, r in zip(got, ref)), default=math.inf)
    return {
        "kind": "serve", "attempted": len(lat) + failed, "failed": failed,
        "setup_s": setup_s, "window_s": window_s, "requests": len(lat),
        "latencies_s": lat, "wall_sum_s": float(sum(lat)), "frames": frames,
        "flops": flops, "roofline_s": roof, "launches": launches,
        "memory_peak_bytes": peak, "trace": summary,
        "readings": {"max_abs_err": err},
    }
