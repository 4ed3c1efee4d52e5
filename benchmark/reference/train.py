"""One training step in plain PyTorch: the forward of lista.py on a noisy
batch, the mean squared error against the clean batch, gradients by
autograd, Adam after clipping the gradients' global norm, and the
projection.

Adam follows optax's chain(clip_by_global_norm(c), adam(lr)):

    g  = g if |g| < c else g * c / |g|          (|g| over every leaf)
    mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
    p += -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

with b1 0.9, b2 0.999, eps 1e-8, each taken as a float32 number. The
projection clamps the thresholds t at 0 and puts each filter of A and B
(over its spatial taps) in the unit l2 ball. A leaf the loss does not
reach (CDLNet's g) has a zero gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.lista import lista_forward

B1, B2, EPS = np.float32(0.9), np.float32(0.999), np.float32(1e-8)


def loss_and_grads(params: dict, noisy, sigma, clean, s: int, tf32: bool = False):
    """(loss, {leaf: gradient}) of the mse of the denoised noisy batch;
    tf32: the convolutions' operands rounded to TF32 (the control)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    xhat = lista_forward(leaves["A"], leaves["B"], leaves["t"], noisy, sigma, s, tf32=tf32)
    loss = torch.mean((xhat - clean) ** 2)
    used = [k for k in ("A", "B", "t")]
    grads = dict(zip(used, torch.autograd.grad(loss, [leaves[k] for k in used])))
    for k in leaves:
        grads.setdefault(k, torch.zeros_like(leaves[k]))
    return loss.detach(), grads


def clip(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    if norm < max_norm:
        return dict(grads)
    return {k: g / norm * max_norm for k, g in grads.items()}


def adam_step(params: dict, grads: dict, state: dict, lr: float) -> None:
    """In place on params and state ({"count", "mu", "nu"})."""
    state["count"] += 1
    t = state["count"]
    c1, c2 = float(1 - B1), float(1 - B2)
    bc1 = float(1 - np.float32(B1) ** np.float32(t))
    bc2 = float(1 - np.float32(B2) ** np.float32(t))
    for k, g in grads.items():
        mu = state["mu"][k] = c1 * g + float(B1) * state["mu"][k]
        nu = state["nu"][k] = c2 * (g * g) + float(B2) * state["nu"][k]
        params[k] = params[k] - float(np.float32(lr)) * ((mu / bc1) / (torch.sqrt(nu / bc2)
                                                                      + float(EPS)))


def project(params: dict) -> None:
    params["t"] = params["t"].clamp(min=0.0)
    for k in ("A", "B"):
        w = params[k]
        axes = tuple(range(3, w.ndim))
        norm = torch.sqrt(torch.sum(w * w, dim=axes, keepdim=True))
        params[k] = w * torch.clamp(1.0 / torch.clamp(norm, min=1e-30), max=1.0)


def init_state(params: dict) -> dict:
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def train_steps(params: dict, batches, s: int, lr: float, clip_norm: float,
                tf32: bool = False) -> dict:
    """Run one step a batch from params (not changed). batches: (noisy,
    sigma (N,), clean) each. Returns {"losses": [...], "grad0": the first
    step's clipped gradients, "params": the parameters after the last
    step}. tf32: the convolutions' operands rounded to TF32 (the control)."""
    params = {k: v.detach().clone() for k, v in params.items()}
    state = init_state(params)
    losses, grad0 = [], None
    for noisy, sigma, clean in batches:
        loss, grads = loss_and_grads(params, noisy, sigma, clean, s, tf32)
        grads = clip(grads, clip_norm)
        if grad0 is None:
            grad0 = grads
        adam_step(params, grads, state, lr)
        project(params)
        losses.append(float(loss))
    return {"losses": losses, "grad0": grad0, "params": params}
