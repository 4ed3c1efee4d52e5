#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's video-denoising serve path on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from cdlnet_tpu_torch/kernels/csrc,
checks each against its plain PyTorch version at the flagship shape
(CDLNetVideo K=30, M=169, P=(7,7,5), s=2 on 16x128x128 clips), serves three
flagship clips through Denoiser.denoise_video and counts the kernel
launches, denoises a clip with the trained examples/cdlnet-video-demo
model, and times kernel and plain paths with CUDA events. Any failed phase
raises and the script exits non-zero; without a CUDA device it exits 1
before printing any result. The last line of stdout is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

preceded by the card's nvidia-smi name and power limit and by a JSON line
{"kernels": [...]} with each kernel's launches, error and times.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cdlnet_tpu_torch.core.preprocess import pre_process_3d
from cdlnet_tpu_torch.kernels import _build
from cdlnet_tpu_torch.kernels import lista3d as L
from cdlnet_tpu_torch.models import CDLNetVideo
from cdlnet_tpu_torch.ops import polyphase as pp
from cdlnet_tpu_torch.ops.conv import conv_transpose3d
from cdlnet_tpu_torch.ops.lista import lista_3d
from cdlnet_tpu_torch.serve import Denoiser

FLAGSHIP = dict(K=30, M=169, P=(7, 7, 5), s=2, C=1, adaptive=True, depth=16)
CLIP = (16, 128, 128)
SIGMA = 25.0
SEED = 0
DEMO = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "examples", "cdlnet-video-demo")
SOURCE = "cdlnet_tpu_torch/kernels/csrc/lista3d.cu"
KERNEL_TOL = 1e-4   # one kernel call vs its plain version, max|d| / max|ref|
FORWARD_TOL = 1e-3  # the K=30 forward on the kernels vs the plain loop
MIN_GAIN_DB = 3.0


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rel_err(got, ref) -> tuple[float, float]:
    """(max|got - ref|, max|got - ref| / max|ref|)."""
    d = float((got - ref).abs().max())
    return d, d / float(ref.abs().max())


def cuda_ms(fn, reps: int, rounds: int = 5, warmup: int = 2) -> float:
    """Median over `rounds` of the CUDA-event time per call of `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def smooth_clip(rng, depth, size, n_terms=6) -> np.ndarray:
    """A random smooth 3D field in [0, 1]: sums of separable sin/cos terms."""
    t, y, x = np.meshgrid(*(np.linspace(-np.pi, np.pi, n) for n in (depth, size, size)),
                          indexing="ij")
    field = np.zeros_like(t)
    for _ in range(n_terms):
        a, b, c = rng.uniform(0.5, 3.0, 3)
        ph = rng.uniform(0, 2 * np.pi, 3)
        field += rng.uniform(0.3, 1.0) * np.sin(a * x + ph[0]) * np.cos(b * y + ph[1]) \
            * np.cos(c * t + ph[2])
    return ((field - field.min()) / (field.max() - field.min())).astype(np.float32)


def psnr(x, ref) -> float:
    return float(10 * np.log10(1.0 / np.mean((x - ref) ** 2)))


def main() -> int:
    # --- 1. the device ---
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)

    # --- 2. build the kernels from the checkout's sources ---
    so, build_s = _build.build()
    _build.library()
    spills = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
              if "registers" in ln or "spill" in ln]
    print(f"build: {build_s:.2f} s -> {so.name}; ptxas: {' | '.join(spills)}", flush=True)

    # --- 3. kernel parity at the flagship shape ---
    t0 = time.perf_counter()
    model = CDLNetVideo(**FLAGSHIP, backend="pallas").to(dev)
    model.init(torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    print(f"init: power-method flagship dictionary in {time.perf_counter() - t0:.2f} s",
          flush=True)
    K, M, P, s = FLAGSHIP["K"], FLAGSHIP["M"], FLAGSHIP["P"], FLAGSHIP["s"]
    clean = smooth_clip(rng, *CLIP[:2])
    noisy = clean + SIGMA / 255 * rng.standard_normal(clean.shape).astype(np.float32)
    y = torch.from_numpy(noisy)[None, None].to(dev)
    yp, _, _ = pre_process_3d(y, s)
    # thresholds > 0 so the soft threshold is exercised (the init's t0 is 0)
    tg = torch.Generator().manual_seed(SEED + 1)
    t_par = (torch.rand(K, 2, M, 1, 1, 1, generator=tg) * torch.tensor([0.02, 0.2])
             .reshape(1, 2, 1, 1, 1, 1)).to(dev)
    c = SIGMA / 255
    pads = model.pad
    geom = L.Geom(s, P, pads)
    with torch.inference_mode():
        wa = L.prep_A2m_3d(model.A, s, pads)
        ws = L.prep_B2m_3d(model.B, s, pads)
        y2 = pp.space_to_depth(yp, s, 3).contiguous()
        tau = (t_par[:, 0, :, 0, 0, 0] + c * t_par[:, 1, :, 0, 0, 0])[:, None].contiguous()
        mask2 = (torch.rand(y2.shape, generator=tg) > 0.3).float().to(dev)
        err = {"lista3d_ana_threshold": 0.0, "lista3d_syn_residual": 0.0}
        z0 = L.lista3d_ana_threshold_plain(-y2, None, wa[0], tau[0], geom)
        r1 = L.lista3d_syn_residual_plain(z0, ws[1], geom, y=y2)
        cases = [
            ("lista3d_ana_threshold", "k=0 (r=-y2, z=0)",
             lambda f: f(-y2, None, wa[0], tau[0], geom)),
            ("lista3d_ana_threshold", "k=1",
             lambda f: f(r1, z0, wa[1], tau[1], geom)),
            ("lista3d_syn_residual", "residual B1 z - y",
             lambda f: f(z0, ws[1], geom, y=y2)),
            ("lista3d_syn_residual", "masked residual",
             lambda f: f(z0, ws[2], geom, mask=mask2, y=y2)),
            ("lista3d_syn_residual", "final B0 z", lambda f: f(z0, ws[0], geom)),
        ]
        for name, what, run in cases:
            got = run(getattr(L, name))
            ref = run(getattr(L, name + "_plain"))
            torch.cuda.synchronize()
            d, rel = rel_err(got, ref)
            print(f"parity {name} [{what}]: max|d| {d:.3e}, rel {rel:.3e}", flush=True)
            require(rel <= KERNEL_TOL, f"{name} [{what}] rel err {rel:.3e} > {KERNEL_TOL}")
            err[name] = max(err[name], d)

        x_k, z_k = L.lista3d_fused(yp, model.A, model.B, t_par, c, stride=s)
        z_p = lista_3d(yp, model.A, model.B, t_par, c, stride=s)
        x_p = conv_transpose3d(z_p, model.B[0], stride=s, padding=pads,
                               output_padding=s - 1)
        torch.cuda.synchronize()
        for what, got, ref in (("x", x_k, x_p), ("z", z_k, z_p)):
            d, rel = rel_err(got, ref)
            print(f"parity K={K} forward {what}: max|d| {d:.3e}, rel {rel:.3e}", flush=True)
            require(rel <= FORWARD_TOL, f"K={K} forward {what} rel err {rel:.3e}")
        del x_k, z_k, z_p, x_p

    # --- 4. serve three flagship clips through Denoiser (the main path) ---
    server = Denoiser(model)
    clips = [smooth_clip(rng, *CLIP[:2]) for _ in range(3)]
    clips = [x + SIGMA / 255 * rng.standard_normal(x.shape).astype(np.float32)
             for x in clips]
    L.launches.clear()
    outs = [server.denoise_video(x, sigma=SIGMA) for x in clips]
    launches = dict(L.launches)
    print(f"serve: 3 flagship clips, launches {launches}", flush=True)
    require(launches == {"lista3d_ana_threshold": 3 * K, "lista3d_syn_residual": 3 * K},
            f"expected {3 * K} launches of each kernel, got {launches}")
    require(all(o.shape == CLIP and np.isfinite(o).all() for o in outs),
            "non-finite or misshapen serve output")

    # --- 5. the trained demo model: it must denoise, on kernels and plain alike ---
    demo = Denoiser.from_dir(DEMO, device=dev)
    demo_plain = Denoiser.from_dir(DEMO, device=dev, backend="xla")
    clean = smooth_clip(rng, *CLIP[:2])
    noisy = clean + SIGMA / 255 * rng.standard_normal(clean.shape).astype(np.float32)
    out = demo.denoise_video(noisy, sigma=SIGMA)
    out_plain = demo_plain.denoise_video(noisy, sigma=SIGMA)
    d_demo = float(np.abs(out - out_plain).max())
    p_in, p_out = psnr(noisy, clean), psnr(out, clean)
    print(f"demo: PSNR noisy {p_in:.3f} dB -> denoised {p_out:.3f} dB "
          f"(gain {p_out - p_in:.3f} dB); kernel vs plain max|d| {d_demo:.3e}", flush=True)
    require(np.isfinite(out).all() and p_out - p_in >= MIN_GAIN_DB,
            f"demo gain {p_out - p_in:.3f} dB < {MIN_GAIN_DB} dB")
    require(d_demo <= 1e-4, f"demo kernel vs plain max|d| {d_demo:.3e} > 1e-4")

    # --- 6. times at the flagship shape (CUDA events, median of 5) ---
    plain_model = CDLNetVideo(**FLAGSHIP, backend="xla").to(dev)
    plain_model.load_state_dict(model.state_dict())
    yc = torch.from_numpy(clips[0])[None, None].to(dev)
    with torch.inference_mode():
        clip_ms = cuda_ms(lambda: model(yc, SIGMA), reps=3)
        clip_plain_ms = cuda_ms(lambda: plain_model(yc, SIGMA), reps=3)
        r = L.lista3d_syn_residual(z0, ws[1], geom, y=y2)
        times = {
            "lista3d_ana_threshold": (
                cuda_ms(lambda: L.lista3d_ana_threshold(r, z0, wa[1], tau[1], geom), 20),
                cuda_ms(lambda: L.lista3d_ana_threshold_plain(r, z0, wa[1], tau[1], geom),
                        20)),
            "lista3d_syn_residual": (
                cuda_ms(lambda: L.lista3d_syn_residual(z0, ws[1], geom, y=y2), 20),
                cuda_ms(lambda: L.lista3d_syn_residual_plain(z0, ws[1], geom, y=y2), 20)),
        }
    serve_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        server.denoise_video(clips[0], sigma=SIGMA)
        serve_s.append(time.perf_counter() - t0)
    print(f"time [{card}]: flagship clip forward {clip_ms:.3f} ms on the kernels, "
          f"{clip_plain_ms:.3f} ms on the plain loop (backend xla); "
          f"Denoiser.denoise_video {1e3 * statistics.median(serve_s):.3f} ms host clock",
          flush=True)
    for name, (k_ms, p_ms) in times.items():
        print(f"time [{card}]: {name} {k_ms:.4f} ms/call, plain {p_ms:.4f} ms/call",
              flush=True)

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": "cdlnet_tpu/kernels/lista3d.py:325",
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("lista3d_ana_threshold", "lista3d_syn_residual")
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
