"""Inputs and weights made on the device from the run's seed.

Every random number comes from a torch.Generator on the device, seeded
from (--seed, a label), so that the same seed gives the same inputs and
weights, and each label its own stream. Frames are smooth moving textures:
sums of plane waves at random spatial frequencies (amplitude falling with
frequency), drifting from frame to frame, scaled to [0, 1]. Noise is
additive white Gaussian at sigma / 255.

The weights are the models' power-method initialisation, made here: one
random bank W shared by every A_k and B_k, scaled by 1 / sqrt(L), L the
largest eigenvalue of D D^T on a 128^2 probe (depth frames deep in 3D);
the thresholds t are drawn positive (t[k, 0] in [0, 0.02), t[k, 1] in
[0, 0.2)) so that the soft threshold does work; CDLNet's unused g is 0.
"""

from __future__ import annotations

import hashlib
import math

import torch

from reference.lista import exact_fp32, power_method_scale

WAVES = 8


def derived(seed: int, label: str) -> int:
    """A 63-bit seed of its own for each (seed, label)."""
    digest = hashlib.sha256(f"{int(seed)}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, label: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derived(seed, label))
    return g


def portrait(share, i: int) -> bool:
    """Whether item i of a set is portrait (served or staged transposed):
    every round(1 / share)-th item, none when share is 0 or missing."""
    every = round(1 / share) if share else 0
    return bool(every) and i % every == every - 1


def texture(g, frames: int, H: int, W: int, device) -> torch.Tensor:
    """One smooth moving texture (frames, H, W) in [0, 1]."""
    kw = dict(generator=g, device=device)
    freq = 0.5 + 7.5 * torch.rand(WAVES, 2, **kw) ** 2  # cycles a frame side
    sign = torch.where(torch.rand(WAVES, 2, **kw) < 0.5, -1.0, 1.0)
    amp = 1.0 / freq.norm(dim=1)
    drift = 0.3 * torch.randn(WAVES, **kw)  # radians a frame
    phase = 2 * math.pi * torch.rand(WAVES, **kw)
    y = torch.linspace(0, 1, H, device=device).view(1, H, 1)
    x = torch.linspace(0, 1, W, device=device).view(1, 1, W)
    t = torch.arange(frames, device=device, dtype=torch.float32).view(frames, 1, 1)
    out = torch.zeros(frames, H, W, device=device)
    for j in range(WAVES):
        fy, fx = (freq[j] * sign[j]).tolist()
        out += amp[j] * torch.cos(2 * math.pi * (fy * y + fx * x) + drift[j] * t + phase[j])
    lo, hi = out.min(), out.max()
    return (out - lo) / (hi - lo)


def noisy(g, clean: torch.Tensor, sigma) -> torch.Tensor:
    """clean + sigma / 255 * N(0, 1); sigma a number or one per item."""
    s = torch.as_tensor(sigma, dtype=clean.dtype, device=clean.device)
    s = s.reshape((-1,) + (1,) * (clean.ndim - 1)) if s.ndim else s
    return clean + s / 255.0 * torch.randn(clean.shape, generator=g, device=clean.device)


def weights(model: dict, seed: int, device) -> dict:
    """{A, B, t[, g]} for the model keys of a configuration (K, M, P, s, C;
    depth for a clip model)."""
    g = generator(seed, "weights", device)
    K, M, C, s = model["K"], model["M"], model["C"], model["s"]
    clip = "depth" in model
    P = model["P"]
    P = list(P) if isinstance(P, (list, tuple)) else [P] * (3 if clip else 2)
    W = torch.randn(M, C, *P, generator=g, device=device)
    probe_shape = (model["depth"], 128, 128) if clip else (128, 128)
    probe = torch.rand(1, C, *probe_shape, generator=g, device=device)
    with exact_fp32():
        W = W * power_method_scale(W, s, probe)
    ones = (1,) * len(P)
    t = torch.rand(K, 2, M, *ones, generator=g, device=device)
    t = t * torch.tensor([0.02, 0.2], device=device).view(1, 2, 1, *ones)
    out = {"A": W.expand(K, *W.shape).contiguous(), "B": W.expand(K, *W.shape).contiguous(),
           "t": t}
    if not clip:
        out["g"] = torch.zeros_like(t)
    return out
