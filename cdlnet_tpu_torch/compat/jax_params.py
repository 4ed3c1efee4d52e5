"""The JAX package's params dict <-> a cdlnet_tpu_torch module's state.

The port keeps the JAX params names and layouts (torch conv layout already),
so the map joins nested dict names with '.' and turns numpy into tensors.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _flatten(params: dict, prefix: str = "") -> dict:
    state = {}
    for name, val in params.items():
        if isinstance(val, dict):
            state.update(_flatten(val, prefix + name + "."))
        else:
            state[prefix + name] = torch.from_numpy(np.array(val, copy=True))
    return state


def load_jax_params(module: nn.Module, params: dict) -> nn.Module:
    """Copy a JAX params dict (nested dict of numpy-convertible arrays, e.g.
    {'A': .., 'B': .., 't': ..}) into `module`, strictly: every name must
    match in name and shape. Returns the module."""
    module.load_state_dict(_flatten(params), strict=True)
    return module


def export_jax_params(module: nn.Module) -> dict:
    """The module's state as a JAX params dict of numpy arrays."""
    params: dict = {}
    for key, val in module.state_dict().items():
        *path, leaf = key.split(".")
        node = params
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = val.detach().cpu().numpy()
    return params
