"""The work of the algorithm, counted from a configuration and shapes, and
the card's published peaks.

Counts are of the algorithm, not of whatever implements it, so that no
share of a peak or of a roofline can pass 100%:

- one convolution (an analysis A_k or a synthesis B_k) does
  2 x code positions x M x taps x C operations, the code positions being
  the input's own size over the stride (rounded up per axis, not the
  bucketed size), the taps every tap of the filter (the banks are dense);
- a forward is 2K convolutions (K analyses, K - 1 syntheses in the loop,
  the final synthesis);
- a trained sample is 3 forwards: the forward, the gradient to the input
  and the gradient to the weights; recomputation is not counted.

The compulsory bytes are those a call cannot avoid: its input, weights and
output (float32) read or written once each; a training step reads its
clean batch, reads and writes each parameter and Adam's two moments of it.
The roofline time is the larger of operations over the dense TF32
tensor-core peak and bytes over the memory bandwidth.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM, dense rates without sparsity (NVIDIA's data sheet, at
# the full 700 W power limit)
TF32_PEAK_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
FP32 = 4


def taps(model: dict) -> int:
    P = model["P"]
    ndim = 3 if "depth" in model else 2
    P = [P] * ndim if isinstance(P, int) else list(P)
    return math.prod(P)


def code_positions(spatial, s: int) -> int:
    """spatial: the input's (H, W) or (D, H, W)."""
    return math.prod(-(-n // s) for n in spatial)


def conv_flops(model: dict, spatial) -> int:
    return 2 * code_positions(spatial, model["s"]) * model["M"] * taps(model) * model["C"]


def forward_flops(model: dict, spatial) -> int:
    """One input's forward (a clip or an image)."""
    return 2 * model["K"] * conv_flops(model, spatial)


def train_sample_flops(model: dict, spatial) -> int:
    return 3 * forward_flops(model, spatial)


def param_bytes(model: dict) -> int:
    K, M, C = model["K"], model["M"], model["C"]
    return FP32 * (2 * K * M * C * taps(model) + 2 * K * M)


def forward_bytes(model: dict, spatial) -> int:
    """One input's compulsory bytes: the input and output, the weights."""
    return 2 * FP32 * model["C"] * math.prod(spatial) + param_bytes(model)


def train_step_bytes(model: dict, spatial, batch: int) -> int:
    """One step's: the clean batch, parameters and Adam's moments read and
    written."""
    return FP32 * batch * model["C"] * math.prod(spatial) + 6 * param_bytes(model)


def roofline_s(flops: float, nbytes: float) -> float:
    return max(flops / TF32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def bound_by(flops: float, nbytes: float) -> str:
    return "operations" if flops / TF32_PEAK_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
