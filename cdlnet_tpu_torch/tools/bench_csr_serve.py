#!/usr/bin/env python3
"""Time the frame-recurrent CSR serve path of one checkout on the GPU.

    python3 cdlnet_tpu_torch/tools/bench_csr_serve.py [--root DIR] [--label NAME]

At the argscsr width (CDLNet_CSR and CDLNet_CSRf2, K=30, M=169, P=9, s=2,
adaptive; chip_smoke.py's csr_models weights) it times, on the kernels:
a 16x640x368 volume through Denoiser.denoise_video at a known sigma (host
clock), one K=30 forward of a native 640x368 frame with its neighbour codes
(CUDA events), the CSR analysis kernels, the ST analysis and the P=9
synthesis per call on iteration 1's operands at the 640x384 bucket and at
2 x 128^2 (sigmas 20 and 30), beside the one strided PyTorch call of the
analyses' correlation (F.conv2d, cuDNN in fp32), and the CSR synthesis
adjoints with the ST one on the same operands (iteration 1's codes, u
history and neighbour codes, a seeded cotangent g and base, alpha -1 as
the reverse loop runs them) beside the strided F.conv2d of their
correlation (g with B_1), each over calls launched
one after another ("ms", CUDA events) and over the same calls replayed
from a CUDA graph ("graph ms": the device's time alone), and both models'
native train step (make_csr_train_step on a clean 640x368 frame pair or
triple, noise drawn on the card, remat "auto" and off; host clock, the
host's issue time and the device's busy time in a profiler trace). It
prints the card's nvidia-smi name and power limit and then one JSON line
with every median and every round's reading.

--root is the checkout whose cdlnet_tpu_torch is imported (by default the
one that holds this script). Two commits compare by running the script
once per checkout in turns (A B B A ...) on one card: the kernels build
into each checkout's own build directory.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from bench_video_serve import graph_ms, rounds_ms, smooth, step_times  # noqa: E402

SIGMA = 25.0
SEED = 0
CSR_WIDTH = dict(K=30, M=169, P=9, s=2, C=1, adaptive=True)
FRAME, BUCKET, DEPTH = (640, 368), (640, 384), 16
SMALL, SMALL_SIGMAS = (128, 128), (20.0, 30.0)  # chip_smoke.py's 2 x 128^2 kernel shape


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
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_csr_serve: needs a GPU", file=sys.stderr)
        return 1
    from cdlnet_tpu_torch.core.preprocess import pre_process
    from cdlnet_tpu_torch.kernels import _build
    from cdlnet_tpu_torch.kernels import lista2d as L2
    from cdlnet_tpu_torch.kernels import lista2d_bwd as LB2
    from cdlnet_tpu_torch.kernels.lista3d_bwd import adjoint_bank
    from cdlnet_tpu_torch.models import CDLNetCSR, CDLNetCSRf2
    from cdlnet_tpu_torch.ops import polyphase as pp
    from cdlnet_tpu_torch.serve import Denoiser
    from cdlnet_tpu_torch.train.fit_csr import make_csr_train_step
    from cdlnet_tpu_torch.train.optim import make_optimizer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda")
    f2 = CDLNetCSRf2(**CSR_WIDTH, backend="pallas").to(dev).init(
        torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 4)
    with torch.no_grad():
        f2.t.copy_(torch.rand(f2.t.shape, generator=g)
                   * torch.tensor([0.02, 0.2]).reshape(1, 2, 1, 1, 1))
        f2.g1.copy_(0.3 * torch.rand(f2.g1.shape, generator=g))
        f2.g2.copy_(0.3 * torch.rand(f2.g2.shape, generator=g))
        one = CDLNetCSR(**CSR_WIDTH, backend="pallas").to(dev)
        for name, src in (("A", f2.A), ("B", f2.B), ("t", f2.t), ("A2", f2.A),
                          ("B2", f2.B), ("t2", f2.t), ("g", f2.g1)):
            getattr(one, name).copy_(src)
    models = {"CDLNet_CSR": one.eval(), "CDLNet_CSRf2": f2.eval()}
    rng = np.random.default_rng(SEED)
    res = {"label": a.label, "card": card, "rounds": {}}

    def record(key, vals):
        res["rounds"][key] = [round(v, 4) for v in vals]
        res[key] = round(statistics.median(vals), 4)

    with torch.inference_mode():
        # one native frame and its neighbours' codes: the K=30 forwards
        y = torch.from_numpy(smooth(rng, 3, FRAME)[None]).to(dev)
        y = y + SIGMA / 255 * torch.randn(y.shape, generator=torch.Generator(
            device=dev).manual_seed(SEED), device=dev)
        zp, za = f2(y[:, 0:1], sigma=SIGMA)[1], f2(y[:, 2:3], sigma=SIGMA)[1]
        for family, kw in (("CDLNet_CSR", dict(z_prev=zp)),
                           ("CDLNet_CSRf2", dict(z_prev=zp, z_after=za))):
            m = models[family]
            record(f"{family} forward ms",
                   rounds_ms(lambda: m(y[:, 1:2], sigma=SIGMA, **kw), 2 * a.rounds))
        # the kernels per call on iteration 1's operands, at the 640x384
        # bucket (keys without a shape) and at 2 x 128^2
        for label, shape, sigmas in (("", BUCKET, (SIGMA,)), (" 2x128^2", SMALL, SMALL_SIGMAS)):
            N = len(sigmas)
            yb = torch.from_numpy(np.stack([smooth(rng, 3, shape) for _ in sigmas])).to(dev)
            sig = torch.tensor(sigmas, device=dev)
            zp, za = f2(yb[:, 0:1], sigma=sig)[1], f2(yb[:, 2:3], sigma=sig)[1]
            yp, _, _ = pre_process(yb[:, 1:2], f2.s)
            c = sig / 255
            y2, _, wa, ws, tau, geom = L2.phase_operands(yp, f2.A, f2.B, f2.t, c, f2.s)
            gam1, gam2 = (L2.threshold_bank(b, c, N, yp) for b in (f2.g1, f2.g2))
            z0 = L2.lista2d_ana_csrf2(-y2, None, wa[0], tau[0], gam1[0], gam2[0], zp, za, geom)
            r1 = L2.lista2d_syn_residual(z0, ws[1], geom, y=y2)
            r_full = pp.depth_to_space(r1, f2.s, 2, 1)
            # the reverse pass's operands at iteration 1: its codes, u histories
            # (one-sided and two-sided), a cotangent g of the synthesis output,
            # a base and B_1's unflipped bank
            u1, u1f2 = torch.empty_like(z0), torch.empty_like(z0)
            z1 = L2.lista2d_ana_csr(r1, z0, wa[1], tau[1], gam1[1], zp, geom, u_out=u1)
            z1f2 = L2.lista2d_ana_csrf2(r1, z0, wa[1], tau[1], gam1[1], gam2[1], zp, za, geom,
                                        u_out=u1f2)
            gen = torch.Generator(device=dev).manual_seed(SEED + 5)
            g = torch.randn(y2.shape, generator=gen, device=dev)
            base = 1e-2 * torch.randn(z0.shape, generator=gen, device=dev)
            g_full = pp.depth_to_space(g, f2.s, 2, 1)
            wt = adjoint_bank(ws, 2)[1]
            dzp, dza = torch.zeros_like(z0), torch.zeros_like(z0)
            for name, fn in (
                ("lista2d_syn_adjoint_csr", lambda: LB2.lista2d_syn_adjoint_csr(
                    g, wt, z1, u1, tau[1], gam1[1], zp, dzp, geom, base=base, alpha=-1.0)),
                ("lista2d_syn_adjoint_csrf2", lambda: LB2.lista2d_syn_adjoint_csrf2(
                    g, wt, z1f2, u1f2, tau[1], gam1[1], gam2[1], zp, za, dzp, dza, geom,
                    base=base, alpha=-1.0)),
                ("lista2d_syn_adjoint", lambda: LB2.lista2d_syn_adjoint(
                    g, wt, z1, geom, base=base, alpha=-1.0)),
                ("F.conv2d (adjoint)", lambda: F.conv2d(g_full, f2.B[1], stride=f2.s,
                                                        padding=f2.pad)),
                ("lista2d_ana_csr", lambda: L2.lista2d_ana_csr(r1, z0, wa[1], tau[1], gam1[1],
                                                               zp, geom)),
                ("lista2d_ana_csrf2", lambda: L2.lista2d_ana_csrf2(
                    r1, z0, wa[1], tau[1], gam1[1], gam2[1], zp, za, geom)),
                ("lista2d_ana_threshold", lambda: L2.lista2d_ana_threshold(
                    r1, z0, wa[1], tau[1], geom)),
                ("F.conv2d", lambda: F.conv2d(r_full, f2.A[1], stride=f2.s, padding=f2.pad)),
                ("lista2d_syn_residual", lambda: L2.lista2d_syn_residual(z0, ws[1], geom, y=y2)),
            ):
                record(f"{name}{label} ms", rounds_ms(fn, a.rounds, reps=20))
                record(f"{name}{label} graph ms", graph_ms(fn, a.rounds, 20))
        # a native volume through the serve path
        vol = smooth(rng, DEPTH, FRAME)
        vol = vol + SIGMA / 255 * rng.standard_normal(vol.shape).astype(np.float32)
    for family, m in models.items():
        server = Denoiser(m)
        record(f"{family} volume ms", rounds_ms(
            lambda: server.denoise_video(vol, sigma=SIGMA), a.rounds, warmup=1, events=False))
    # the native train steps (chip_smoke.py's csr_train R3)
    frames = torch.from_numpy(smooth(rng, 3, FRAME)[None, None]).to(dev)
    for family, m in models.items():
        batch = frames[:, :, :3 if family == "CDLNet_CSRf2" else 2]
        for remat in ("auto", False):
            opt = make_optimizer(1e-4, clip_grad=0.05)
            state = opt.init(dict(m.named_parameters()))
            step, _ = make_csr_train_step(m.train(), opt, noise_std=(20.0, 30.0), remat=remat)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            torch.cuda.empty_cache()
            step_times(record, f"{family} native step remat={remat}",
                       lambda: step(state, batch, gen), a.rounds)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
