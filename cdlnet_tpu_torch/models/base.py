"""Model registry and shared helpers (counterpart of
cdlnet_tpu/models/base.py).

Dispatch is by exact name from an args.json 'type' + 'model' (reference
schema). The `backend` field keeps the reference schema's values: "pallas"
and "cuda" select the hand-written kernels (kernels/lista2d.py,
kernels/lista3d.py), "xla" selects the plain PyTorch loop (ops/lista.py).
The port has one kernel path per model family, so the JAX package's
routing by VMEM budget (kernels/routing.py) reduces to that choice.
DnCNN and FFDNet have no kernel path and no `backend` field.
"""

from __future__ import annotations

import inspect

import torch

MODEL_REGISTRY: dict = {}
BACKENDS = ("pallas", "cuda", "xla")


def register(name):
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        return cls

    return deco


def build_model(model_type: str, model_args: dict):
    """Construct a model from an args.json 'type' + 'model' ("JDD_CDLNet"
    is CDLNet). The 'init' key (power-method init at construction in the
    reference) is stripped: the model's init() takes it explicitly."""
    model_type = {"JDD_CDLNet": "CDLNet"}.get(model_type, model_type)
    if model_type not in MODEL_REGISTRY:
        raise NotImplementedError(f"unknown model type {model_type!r}")
    kwargs = {k: v for k, v in model_args.items() if k != "init"}
    return MODEL_REGISTRY[model_type](**kwargs)


def resolve_backend(model_type: str, choice: str = "auto"):
    """The backend a CLI or Denoiser gives a family (the rule of
    cdlnet_tpu/models/base.py::resolve_backend): None when the family of
    the args.json 'type' has no `backend` field (DnCNN, FFDNet), so that
    its config stays as it is; "auto" the hand-written kernels ("pallas")
    on any device; "pallas", "cuda" and "xla" as they are."""
    cls = MODEL_REGISTRY.get({"JDD_CDLNet": "CDLNet"}.get(model_type, model_type))
    if cls is None or "backend" not in inspect.signature(cls.__init__).parameters:
        return None
    return "pallas" if choice == "auto" else choice


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")


def sigma_scale(sigma, adaptive: bool, ndim: int):
    """Threshold scale factor c = sigma/255 (0 if not adaptive or sigma None).

    Accepts scalars or per-sample arrays; reshapes (N,) to (N,1,...,1) so it
    broadcasts against (N, M, *spatial) codes.
    """
    if sigma is None or not adaptive:
        return 0.0
    if isinstance(sigma, (int, float)):
        return float(sigma) / 255.0
    c = torch.as_tensor(sigma, dtype=torch.float32) / 255.0
    if c.ndim == 1:
        c = c.reshape((-1,) + (1,) * (ndim - 1))
    return c
