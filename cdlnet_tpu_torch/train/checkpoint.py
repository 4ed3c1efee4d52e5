"""Reading the JAX package's native .npz checkpoints (counterpart of the
read half of cdlnet_tpu/train/checkpoint.py).

A bundle holds path-flattened params under 'p::' keys written by
jax.tree_util.keystr, e.g. "p::['A']" or "p::['residual']['conv1']",
optimizer leaves under 'o::' (not read here), and a JSON 'meta::json' blob.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

_KEY = re.compile(r"\['([^']*)'\]")


def _resolve(path: str) -> str:
    for cand in (path, path + ".npz"):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(path)


def load_params(path: str) -> tuple[dict, dict]:
    """Read (params, meta) from an .npz bundle: params as a nested dict of
    numpy arrays keyed like the JAX params pytree, meta the JSON blob
    (epoch, lr, ...). Reference torch .ckpt files are not read here."""
    path = _resolve(path)
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only native .npz checkpoints load in cdlnet_tpu_torch "
            "(torch .ckpt import is still to be ported, see ROADMAP.md)"
        )
    with np.load(path) as data:
        data = dict(data)
    meta = json.loads(bytes(data.pop("meta::json"))) if "meta::json" in data else {}
    params: dict = {}
    for key, arr in data.items():
        if not key.startswith("p::"):
            continue
        names = _KEY.findall(key[3:])
        if not names or "".join(f"['{n}']" for n in names) != key[3:]:
            raise ValueError(f"{path}: unsupported params key {key!r}")
        node = params
        for name in names[:-1]:
            node = node.setdefault(name, {})
        node[names[-1]] = arr
    return params, meta
