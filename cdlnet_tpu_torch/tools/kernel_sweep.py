#!/usr/bin/env python3
"""The kernel matrix on the card: every reference geometry through the
hand-written kernels against backend "xla" on identical inputs
(counterpart of tools/hw_kernel_sweep.py, whose 25 cases it replays under
the same names).

    python3 cdlnet_tpu_torch/tools/kernel_sweep.py --out sweep.json [--only TEXT]
    python3 cdlnet_tpu_torch/tools/kernel_sweep.py --out sweep.json --device cpu --tiny

Each case builds its reference config (args.json's 2D flagship, JDD,
args3d, args3dmri, args3dt, argscsr and GDLNet at flagship width) twice,
on backend "pallas" (the CUDA kernels) and on "xla" (the plain PyTorch
loop, cuDNN with TF32 off), with the same power-method weights, and feeds
both the same uniform random input at sigma 25. Eval cases compare the
output, train cases the loss and the gradient of every parameter of
mean(xhat^2) (the kernels' training histories pinned to fp32 for the row,
CDLNET_HIST_DTYPE=f32, as the JAX sweep pins its f32h rows: the gradient
gates below are fp32 ones). Every row is numeric: ok,
rel_vs_xla, its bound and its metric, and sec:
  - the K=30 (K=42 JDD) forwards: max|d| / max|ref| <= 1e-3;
  - gradients: per leaf max|d| / max|ref| <= 1e-3, against "xla" run in
    float64 beside its fp32 run: at the init's zero thresholds dA's fp32
    sums cancel, and both fp32 programs sit up to ~8e-3 from float64 there.
    A leaf's limit is then F64_FACTOR times the fp32 loop's own distance
    (the leaf gated is the row's gate_leaf); rel_vs_xla (the kernels
    against the fp32 loop), each leaf's three numbers and jax_metric (the
    JAX sweep's own comparison: the loss and each leaf's sum of |g|) are
    recorded beside it;
  - the CSR models: forwards relative L2 <= 1e-4, gradients each leaf's
    relative L2 <= 1e-3 (gated as above), on normalized first-frame banks
    (A2 = A, B2 = B), as the JAX sweep gates them.
The TPU's routes (resident, banded, ring, their reverse passes) all map to
the one Hopper kernel set, so the rows whose names carry a route run the
same kernels at that route's geometry; the two 8x256^2 reverse rows run
the same kernel set twice. The lane-class ablation has no lane classes on
Hopper: at its geometry (1x1x16x240x248, K=3 and K=30) it holds the
kernels against "xla" with the JAX sweep's two gates, rel < 2e-3 at both K
and under 5% of the pixels past 1e-4 at K=3.

--tiny shrinks every case (K <= 3, M = 4, sides / 16) for a run on the
CPU, where the kernels' wrappers run their plain versions. The rows go to
--out as JSON; the exit code is 1 if a row fails.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import time

import numpy as np
import torch

SIGMA = 25.0
SEED = 0
FWD_TOL = 1e-3    # max|d| / max|ref|, the K=30 (K=42) forwards
GRAD_TOL = 1e-3   # the largest leaf's max|d| / max|ref|
CSR_FWD_TOL = 1e-4   # relative L2
CSR_GRAD_TOL = 1e-3  # the largest leaf's relative L2
# a train row's leaf may sit up to this many times the fp32 "xla" loop's own
# distance from float64 (where that exceeds the bound): cuDNN's algorithm
# choice moved that distance for dA at args3dt's config between 5.8e-3 and
# 7.8e-3 across calls on the H100, the kernels' between 5.9e-3 and 6.8e-3; a
# weight gradient scaled by 1.002 (a planted fault) reads 2e-3 on leaves
# whose fp32 loop sits ~1e-6 from float64 and fails every train row
F64_FACTOR = 2.0
LANE_TOL = 2e-3      # the ablation's rel at K=3 and K=30
LANE_FRAC = 0.05     # its share of pixels past 1e-4 at K=3

FLAG2D = dict(K=30, M=169, P=7, s=2, C=1, adaptive=True)
JDD = dict(K=42, M=64, P=7, s=1, C=3, adaptive=True)
V3D = dict(K=30, M=169, P=(7, 7, 5), s=2, C=1, adaptive=True, depth=16)
MRI = dict(K=30, M=169, P=(9, 9, 5), s=2, C=1, adaptive=True, depth=30)
V3DT = dict(K=30, M=64, P=(7, 7, 5), s=1, C=1, adaptive=True, depth=16)
CSR = dict(K=30, M=169, P=9, s=2, C=1, adaptive=True)
GAB = dict(K=30, M=169, P=7, s=2, C=1, adaptive=True, order=1)


@contextlib.contextmanager
def _f32_histories():
    """CDLNET_HIST_DTYPE=f32 within the block, as it was after."""
    old = os.environ.get("CDLNET_HIST_DTYPE")
    os.environ["CDLNET_HIST_DTYPE"] = "f32"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("CDLNET_HIST_DTYPE")
        else:
            os.environ["CDLNET_HIST_DTYPE"] = old


def _max_rel(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


def _rel_l2(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref).clamp_min(1e-30))


class Sweep:
    """The cases at full size on `device`, or shrunk (tiny)."""

    def __init__(self, device, tiny=False):
        self.dev = torch.device(device)
        self.tiny = tiny
        self.rng = np.random.default_rng(SEED)

    def cfg(self, cfg, **over):
        cfg = dict(cfg, **over)
        if self.tiny:
            cfg.update(K=min(cfg["K"], 3), M=4)
            if "depth" in cfg:
                cfg["depth"] = max(2, cfg["depth"] // 4)
        return cfg

    def img(self, *shape):
        """Uniform [0, 1) input; the tiny run divides the sides by 16 and
        the depth by 4."""
        if self.tiny:
            shape = (*shape[:2], *(max(2, d // 4) for d in shape[2:-2]),
                     *(max(4, d // 16) for d in shape[-2:]))
        return torch.from_numpy(self.rng.random(shape).astype(np.float32)).to(self.dev)

    def pair(self, mtype, cfg, normalize_first=False):
        """The config on "xla" and on the kernels with the same weights."""
        from cdlnet_tpu_torch.models.base import build_model

        ref = build_model(mtype, dict(cfg, backend="xla")).to(self.dev)
        # the power-method init; the tiny run's filters go on the unit ball
        # instead (the 3D power method on the CPU costs seconds a case)
        ref.init(torch.Generator().manual_seed(SEED), init=not self.tiny)
        if self.tiny:
            ref.project()
        if normalize_first:
            with torch.no_grad():
                ref.A2.copy_(ref.A)
                ref.B2.copy_(ref.B)
        ker = build_model(mtype, dict(cfg, backend="pallas")).to(self.dev)
        ker.load_state_dict(ref.state_dict())
        return ref, ker

    @staticmethod
    def loss_and_grads(model, call, dtype):
        """[loss, d loss / d p for every parameter] of mean(xhat^2), xhat =
        call(model, dtype)."""
        xhat = call(model, dtype)
        loss = torch.mean(xhat * xhat)
        params = list(model.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a parameter the forward does not read has a zero gradient, as under jax.grad
        return [loss.detach(), *(torch.zeros_like(p) if g is None else g
                                 for p, g in zip(params, grads))]

    def train_row(self, ref, ker, call, rel, bound, metric) -> dict:
        """The kernels' fp32 loss and gradients against "xla" in fp32 and in
        float64: per leaf [kernels vs xla, kernels vs float64, xla vs
        float64] under `rel`. Gated per leaf: the kernels' distance from
        float64 within `bound`, or within F64_FACTOR times the fp32 loop's
        own distance where that leaf's fp32 sums cancel."""
        names = ["loss", *(n for n, _ in ref.named_parameters())]
        with _f32_histories():
            got = self.loss_and_grads(ker, call, torch.float32)
        want = self.loss_and_grads(ref, call, torch.float32)
        want64 = self.loss_and_grads(copy.deepcopy(ref).double(), call, torch.float64)
        leaves = {n: [rel(a, b), rel(a, c), rel(b, c)]
                  for n, a, b, c in zip(names, got, want, want64)}
        limits = {n: max(bound, F64_FACTOR * v[2]) for n, v in leaves.items()}
        gate = max(leaves, key=lambda n: leaves[n][1] / limits[n])
        # the JAX sweep's own comparison: the loss and each leaf's sum of |g|
        summary = lambda gs: torch.stack([gs[0].double(), *(g.double().abs().sum()
                                                           for g in gs[1:])])
        return {"rel_vs_xla": max(v[0] for v in leaves.values()),
                "rel_vs_f64": max(v[1] for v in leaves.values()),
                "xla_vs_f64": max(v[2] for v in leaves.values()),
                "jax_metric": _max_rel(summary(got), summary(want)),
                "bound": bound, "gate_leaf": gate, "gate_value": leaves[gate][1],
                "limit": limits[gate],
                "metric": f"{metric} per loss and gradient leaf, kernels vs xla fp32, vs "
                          f"xla float64, xla fp32 vs float64; gated per leaf: kernels vs "
                          f"float64 within max(bound, {F64_FACTOR} x xla fp32 vs float64)",
                "leaves": leaves}

    def both(self, mtype, cfg, y, mask=None, train=False):
        """The kernels against "xla": the output, or the loss and every
        gradient leaf."""
        ref, ker = self.pair(mtype, self.cfg(cfg))
        call = lambda m, dt=torch.float32: m(y.to(dt), SIGMA,
                                             mask=None if mask is None else mask.to(dt))[0]
        if train:
            return self.train_row(ref, ker, call, _max_rel, GRAD_TOL, "max|d|/max|ref|")
        with torch.no_grad():
            rel = _max_rel(call(ker), call(ref))
        return {"rel_vs_xla": rel, "bound": FWD_TOL, "metric": "max|d|/max|ref|"}

    def lane_ablation(self):
        """The kernels against "xla" at the ablation's geometry, K=3 and
        K=30 (no lane classes on Hopper)."""
        y = self.img(1, 1, 16, 240, 248)
        out, rels = {}, []
        for K in (3, 30):
            ref, ker = self.pair("CDLNetVideo", self.cfg(V3D, K=K))
            with torch.no_grad():
                got, want = ker(y, SIGMA)[0].double(), ref(y, SIGMA)[0].double()
            d = (got - want).abs() / want.abs().max().clamp_min(1e-12)
            rels.append(float(d.max()))
            out[f"K{K}_rel"] = rels[-1]
            if K == 3:
                out["K3_frac_past_1e-4"] = float((d > 1e-4).double().mean())
                out["frac_bound"] = LANE_FRAC
        out.update(rel_vs_xla=max(rels), bound=LANE_TOL, metric="max|d|/max|ref| at K=3 "
                   "and K=30; share of pixels past 1e-4 at K=3 under frac_bound",
                   note="no lane classes on Hopper: the kernels against xla at the "
                        "ablation's geometry")
        out["ok"] = out["K3_frac_past_1e-4"] < LANE_FRAC
        return out

    def csr(self, mtype, n_codes, train):
        """A CSR model at argscsr width on a 128^2 frame with n_codes
        neighbour codes (0.1 x uniform), normalized first-frame banks."""
        cfg = self.cfg(CSR)
        yf = self.img(1, 1, 128, 128)
        zshape = (1, cfg["M"], yf.shape[2] // cfg["s"], yf.shape[3] // cfg["s"])
        codes = [0.1 * torch.from_numpy(self.rng.random(zshape).astype(np.float32)).to(self.dev)
                 for _ in range(n_codes)]
        ref, ker = self.pair(mtype, cfg, normalize_first=mtype == "CDLNet_CSR")
        call = lambda m, dt=torch.float32: m(yf.to(dt), *(c.to(dt) for c in codes),
                                             sigma=SIGMA)[0]
        note = "normalized first-frame banks"
        if train:
            return dict(self.train_row(ref, ker, call, _rel_l2, CSR_GRAD_TOL, "relative L2"),
                        note=note)
        with torch.no_grad():
            rel = _rel_l2(call(ker), call(ref))
        return {"rel_vs_xla": rel, "bound": CSR_FWD_TOL, "metric": "relative L2",
                "note": note}

    def cases(self):
        """(name, fn) for the 25 cases, named as tools/hw_kernel_sweep.py
        names them (KERNELMATRIX.json)."""
        img = self.img
        same = "the Hopper kernel set that serves every size: "
        out = [
            ("2d-flagship eval 128^2", lambda: self.both("CDLNet", FLAG2D, img(2, 1, 128, 128))),
            ("2d-flagship eval 512^2 banded f32",
             lambda: dict(self.both("CDLNet", FLAG2D, img(1, 1, 512, 512)),
                          note=same + "the banded route's size class")),
            ("2d-flagship eval 320x480 banded f32",
             lambda: dict(self.both("CDLNet", FLAG2D, img(2, 1, 320, 480)),
                          note=same + "the banded route's size class")),
            ("2d-flagship train 128^2",
             lambda: self.both("CDLNet", FLAG2D, img(2, 1, 128, 128), train=True)),
            ("2d-flagship train 256^2 banded-bwd f32h",
             lambda: dict(self.both("CDLNet", FLAG2D, img(1, 1, 256, 256), train=True),
                          note=same + "the banded reverse's size class")),
        ]

        def jdd(train):
            from cdlnet_tpu_torch.data.noise import gen_bayer_mask

            ym = img(2, 3, 128, 128)
            mask = gen_bayer_mask(ym)
            return self.both("CDLNet", JDD, ym * mask, mask=mask, train=train)

        out += [
            ("jdd eval 128^2 masked", lambda: jdd(False)),
            ("jdd train 128^2 masked", lambda: jdd(True)),
            ("3d eval 16x128^2 resident",
             lambda: self.both("CDLNetVideo", V3D, img(1, 1, 16, 128, 128))),
            ("3d train 2x16x128^2 resident",
             lambda: self.both("CDLNetVideo", V3D, img(2, 1, 16, 128, 128), train=True)),
            ("3d eval 16x240x432 ring f32",
             lambda: dict(self.both("CDLNetVideo", V3D, img(1, 1, 16, 240, 432)),
                          note=same + "the ring route's geometry")),
            ("3d train 8x256^2 ring-bwd f32h",
             lambda: dict(self.both("CDLNetVideo", dict(V3D, depth=8), img(1, 1, 8, 256, 256),
                                    train=True),
                          note=same + "the same kernel set as the banded-bwd row")),
            ("3d train 8x256^2 banded-bwd f32h",
             lambda: dict(self.both("CDLNetVideo", dict(V3D, depth=8), img(1, 1, 8, 256, 256),
                                    train=True),
                          note=same + "the same kernel set as the ring-bwd row")),
            ("3d ring lane-class ablation 128-mult", self.lane_ablation),
            ("mri eval 30x128^2 (9,9,5)",
             lambda: self.both("CDLNetVideo", MRI, img(1, 1, 30, 128, 128))),
            ("mri train 1x30x128^2 (9,9,5) f32h",
             lambda: self.both("CDLNetVideo", MRI, img(1, 1, 30, 128, 128), train=True)),
            ("mri eval 30x320x192 ring (9,9,5) f32",
             lambda: dict(self.both("CDLNetVideo", MRI, img(1, 1, 30, 320, 192)),
                          note=same + "the ring route's geometry")),
            ("3dt eval 16x64^2 s1", lambda: self.both("CDLNetVideo", V3DT, img(1, 1, 16, 64, 64))),
            ("3dt train 16x64^2 s1",
             lambda: self.both("CDLNetVideo", V3DT, img(1, 1, 16, 64, 64), train=True)),
        ]
        for mtype, n_codes in (("CDLNet_CSR", 0), ("CDLNet_CSR", 1), ("CDLNet_CSRf2", 2)):
            for train in (False, True):
                out.append((f"csr {mtype} n_codes={n_codes} {'train' if train else 'eval'}",
                            lambda m=mtype, n=n_codes, t=train: self.csr(m, n, t)))
        out.append(("gdlnet train 128^2",
                    lambda: self.both("GDLNet", GAB, img(2, 1, 128, 128), train=True)))
        return out


def run_case(name, fn) -> dict:
    """One row: the case's numbers, ok when rel_vs_xla is finite and under
    its bound (and the case's own gate), else the error."""
    t0 = time.perf_counter()
    try:
        row = {"case": name, **fn()}
        value = row.get("gate_value", row["rel_vs_xla"])
        ok = bool(np.isfinite(value) and value <= row.get("limit", row["bound"])
                  and row.get("ok", True))
        row.update(ok=ok, sec=round(time.perf_counter() - t0, 3))
    except Exception as e:  # noqa: BLE001 - recorded in the row, the run goes on
        row = {"case": name, "ok": False, "rel_vs_xla": None, "bound": None,
               "sec": round(time.perf_counter() - t0, 3),
               "error": f"{type(e).__name__}: {str(e)[:300]}"}
    return row


def run_sweep(device="cuda", tiny=False, only=None, log=print) -> list:
    """Every case (or those whose name holds `only`) as rows, with TF32
    off for the plain side."""
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rows = []
        for name, fn in Sweep(device, tiny).cases():
            if only is not None and only not in name:
                continue
            row = run_case(name, fn)
            rows.append(row)
            if log is not None:
                log(f"{'PASS' if row['ok'] else 'FAIL'} {json.dumps(row)}")
        return rows
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True, help="the JSON file to write")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="shrunk cases (a CPU run)")
    p.add_argument("--only", default=None, help="run the cases whose name holds this")
    a = p.parse_args()
    if a.device.startswith("cuda") and not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device (pass --device cpu --tiny for the CPU)",
              file=sys.stderr)
        return 1
    rows = run_sweep(a.device, a.tiny, a.only, log=lambda s: print(s, flush=True))
    ok = all(r["ok"] for r in rows)
    result = {"date": time.strftime("%Y-%m-%d"), "device": str(a.device),
              "kind": torch.cuda.get_device_name(0) if a.device.startswith("cuda") else "cpu",
              "tiny": a.tiny, "all_ok": ok, "cases": rows}
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"{'ALL PASS' if ok else 'FAILURES'} -> {a.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    sys.exit(main())
