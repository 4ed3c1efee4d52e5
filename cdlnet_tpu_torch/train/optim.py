"""Adam preceded by global-norm clipping, with optax's semantics
(counterpart of cdlnet_tpu/train/optim.py, which chains
optax.clip_by_global_norm and optax.inject_hyperparams(optax.adam)).

The state mirrors optax's: the hyperparameters, the learning rate among
them, live in the state (so backtracking and StepLR change the lr there),
beside the step count and the first and second moments of each parameter.
As in inject_hyperparams, each hyperparameter takes part in the update as
a float32 number (1 - b2 is 1 - float32(0.999), not 0.001).
train/checkpoint.py writes it under optax's own npz keys, so optimizer
state crosses between the packages.

The step count is a 0-d int32 tensor on the parameters' device, and the
update reads the hyperparameters from 0-d float32 copies there
("hyperparams_dev", made from "hyperparams", which keep the host's
numbers): it computes the bias corrections and the step size on the
device, so a CUDA graph that captured an update replays the later steps
too. set_lr and the checkpoint loaders write the host number and its
device copy in place (set_hyperparam, set_count) and rebind neither.
"""

from __future__ import annotations

import torch


class ClippedAdam:
    """optax.chain(clip_by_global_norm(clip_grad), adam(lr, b1, b2, eps)),
    the clip left out when clip_grad is None:

      g     = g if |g| < clip_grad else (g / |g|) * clip_grad   (|g| global)
      mu    = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
      p    += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t) + eps_root) + eps)

    Unlike torch.nn.utils.clip_grad_norm_ the clip adds no epsilon to the
    norm, and eps sits outside the square root, as in optax.
    """

    def __init__(self, lr: float, clip_grad=None, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.clip_grad, self.betas, self.eps = lr, clip_grad, betas, eps

    def init(self, params: dict) -> dict:
        """Fresh state for a dict of named parameters, on their device."""
        zeros = lambda: {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                         for k, p in params.items()}
        state = {
            # position of the Adam state in optax's chain (after the clip)
            "index": 0 if self.clip_grad is None else 1,
            "count": 0,
            "hyperparams": {"b1": self.betas[0], "b2": self.betas[1],
                            "eps": self.eps, "eps_root": 0.0,
                            "learning_rate": self.lr},
            "mu": zeros(),
            "nu": zeros(),
        }
        return place_scalars(state, next(iter(params.values())).device)

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict) -> dict:
        """One step, in place on params and state. Returns state."""
        names = list(params)
        g = [grads[k] for k in names]
        if self.clip_grad is not None:
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            keep = norm < self.clip_grad
            g = [torch.where(keep, x, (x / norm) * self.clip_grad) for x in g]
        place_scalars(state, params[names[0]].device)
        hp = state["hyperparams_dev"]
        state["count"].add_(1)
        # float32 arithmetic on 0-d tensors of the device, as optax's
        b1, b2, eps, eps_root = (hp[k] for k in ("b1", "b2", "eps", "eps_root"))
        c1, c2 = 1 - b1, 1 - b2
        t = state["count"].to(torch.float32)
        bc1 = 1 - b1**t
        bc2 = 1 - b2**t
        step = -hp["learning_rate"]
        for k, x in zip(names, g):
            mu = state["mu"][k]
            nu = state["nu"][k]
            mu.copy_(c1 * x + b1 * mu)
            nu.copy_(c2 * (x * x) + b2 * nu)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2 + eps_root) + eps)
            params[k].add_(step * upd)
        return state


def make_optimizer(lr: float, clip_grad=None, betas=(0.9, 0.999), eps=1e-8):
    """Adam preceded by global-norm clipping (train.py:99-101, 200)."""
    return ClippedAdam(lr, clip_grad=clip_grad, betas=betas, eps=eps)


def place_scalars(state: dict, device) -> dict:
    """Make the count a 0-d int32 tensor on `device` if it is a number, and
    bring state["hyperparams_dev"], 0-d float32 tensors there, to the
    values of state["hyperparams"] (made where missing, filled in place
    where they differ). Returns state."""
    if not isinstance(state["count"], torch.Tensor):
        state["count"] = torch.tensor(int(state["count"]), dtype=torch.int32, device=device)
    dev = state.setdefault("hyperparams_dev", {})
    held = state.setdefault("hyperparams_held", {})
    for k, v in state["hyperparams"].items():
        if k not in dev:
            dev[k] = torch.tensor(float(v), dtype=torch.float32, device=device)
        elif held.get(k) != v:
            with torch.no_grad():
                dev[k].fill_(float(v))
        held[k] = v
    return state


def set_hyperparam(state: dict, key: str, value: float) -> None:
    """state["hyperparams"][key] = value, and its device copy filled in
    place now (a captured CUDA graph reads that tensor)."""
    state["hyperparams"][key] = value
    dev = state.get("hyperparams_dev")
    if dev:
        place_scalars(state, next(iter(dev.values())).device)


def set_count(state: dict, count: int) -> None:
    """The step count, written into the count tensor when there is one."""
    if isinstance(state["count"], torch.Tensor):
        with torch.no_grad():
            state["count"].fill_(int(count))
    else:
        state["count"] = int(count)


def get_lr(opt_state: dict) -> float:
    return float(opt_state["hyperparams"]["learning_rate"])


def set_lr(opt_state: dict, lr: float) -> dict:
    """Replace the learning rate in opt_state (in place). Returns it."""
    set_hyperparam(opt_state, "learning_rate", float(lr))
    return opt_state


def steplr_value(base_lr: float, epoch: int, step_size: int, gamma: float) -> float:
    """torch StepLR: lr = base * gamma^(epoch // step_size)."""
    return base_lr * (gamma ** (epoch // step_size))
