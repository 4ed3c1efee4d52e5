"""The JAX package's params dict <-> a cdlnet_tpu_torch module's state.

The port keeps the JAX params names and layouts (torch conv layout already),
so the map joins nested dict names with '.' and turns numpy into tensors.
A stateful family (DnCNN, FFDNet: BatchNorm running statistics) is carried
as the JAX package's (params, state) pair: params onto the module's
parameters, state onto its buffers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def is_stateful(module: nn.Module) -> bool:
    """Whether the module keeps state beside its parameters (buffers in
    its state dict, as DnCNN's running statistics), as the JAX package
    tells a stateful family by its (params, state) bundle."""
    return any(True for _ in module.buffers())


def _flatten(params: dict, prefix: str = "") -> dict:
    state = {}
    for name, val in params.items():
        if isinstance(val, dict):
            state.update(_flatten(val, prefix + name + "."))
        else:
            state[prefix + name] = torch.from_numpy(np.array(val, copy=True))
    return state


def _nest(named) -> dict:
    tree: dict = {}
    for key, val in named:
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = val.detach().cpu().numpy()
    return tree


def load_jax_params(module: nn.Module, params) -> nn.Module:
    """Copy JAX params into `module`, strictly: every name must match in
    name and shape. params is a nested dict of numpy-convertible arrays
    (e.g. {'A': .., 'B': .., 't': ..}), or for a stateful family the
    (params, state) pair. Returns the module."""
    if isinstance(params, tuple):
        params, state = params
        flat = {**_flatten(params), **_flatten(state)}
    else:
        flat = _flatten(params)
    module.load_state_dict(flat, strict=True)
    return module


def export_jax_params(module: nn.Module):
    """The module's state as JAX params of numpy arrays: a nested dict, or
    for a stateful family the (params, state) pair."""
    params = _nest(module.named_parameters())
    if is_stateful(module):
        return params, _nest(module.named_buffers())
    return params
