"""The JAX package's native .npz checkpoints, written and read (counterpart
of the npz half of cdlnet_tpu/train/checkpoint.py).

A bundle holds path-flattened params under 'p::' keys written by
jax.tree_util.keystr, e.g. "p::['A']" or "p::['residual']['conv1']",
optimizer leaves under 'o::' keys of optax's state (with clipping, the
Adam state is entry 1 of the chain: "o::[1].count",
"o::[1].hyperparams['learning_rate']", "o::[1].inner_state[0].mu['A']",
...), and a JSON 'meta::json' blob (epoch, lr). Bundles written here load
in the JAX package and the other way round. Orbax directories and torch
.ckpt files are still to be ported (see ROADMAP.md).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from cdlnet_tpu_torch.compat.jax_params import load_jax_params

_KEY = re.compile(r"\['([^']*)'\]")


def _resolve(path: str) -> str:
    for cand in (path, path + ".npz"):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(path)


def _read(path: str) -> tuple[dict, dict, str]:
    """(all arrays by key, meta, resolved path) of an .npz bundle."""
    path = _resolve(path)
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only native .npz checkpoints load in cdlnet_tpu_torch "
            "(torch .ckpt import is still to be ported, see ROADMAP.md)"
        )
    with np.load(path) as data:
        data = dict(data)
    meta = json.loads(bytes(data.pop("meta::json"))) if "meta::json" in data else {}
    return data, meta, path


def load_params(path: str) -> tuple[dict, dict]:
    """Read (params, meta) from an .npz bundle: params as a nested dict of
    numpy arrays keyed like the JAX params pytree, meta the JSON blob
    (epoch, lr, ...). Reference torch .ckpt files are not read here."""
    data, meta, path = _read(path)
    return _params(data, path), meta


def _params(data: dict, path: str) -> dict:
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
    return params


def _keystr(name: str) -> str:
    """A module state name ('A', 'residual.conv1') as jax keystr ("['A']")."""
    return "".join(f"['{n}']" for n in name.split("."))


def _opt_leaves(opt_state: dict) -> dict:
    """optax's npz keys -> numpy leaves of an optim.ClippedAdam state: the
    inject_hyperparams state (count, hyperparams) around the Adam state."""
    pre = f"o::[{opt_state['index']}]"
    count = np.asarray(opt_state["count"], np.int32)
    out = {f"{pre}.count": count, f"{pre}.inner_state[0].count": count}
    for k, v in opt_state["hyperparams"].items():
        out[f"{pre}.hyperparams['{k}']"] = np.asarray(v, np.float32)
    for mom in ("mu", "nu"):
        for name, t in opt_state[mom].items():
            out[f"{pre}.inner_state[0].{mom}{_keystr(name)}"] = t.detach().cpu().numpy()
    return out


def save_ckpt(path: str, model, epoch: int = 0, opt_state=None, lr=None,
              extra: dict = None):
    """Save the model's params (+ optimizer state) to an .npz bundle,
    atomically: written to <path>.tmp.npz, then renamed over <path>, so a
    crash mid-write never clobbers the previous complete bundle."""
    data = {"p::" + _keystr(k): v.detach().cpu().numpy()
            for k, v in model.state_dict().items()}
    if opt_state is not None:
        data.update(_opt_leaves(opt_state))
    meta = {"epoch": epoch, "lr": lr}
    if extra:
        meta.update(extra)
    data["meta::json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp.npz"
    np.savez(tmp, **data)
    os.replace(tmp, final)


def save_args(args: dict, save_dir: str, ckpt_name: str = "net.ckpt.npz"):
    """Re-serialize the args.json into the save dir with the ckpt path patched
    in, sorted keys (reference train.py:249-258)."""
    args = json.loads(json.dumps(args))  # deep copy
    args.setdefault("paths", {})["ckpt"] = os.path.join(save_dir, ckpt_name)
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "args.json"), "w") as f:
        f.write(json.dumps(args, indent=4, sort_keys=True))


def load_ckpt(path: str, model, opt_state=None):
    """Restore an .npz bundle into `model` (strictly, in place) and, when
    given, into opt_state (in place; leaves the bundle lacks keep their
    values, as in the JAX package). Returns (model, opt_state, epoch, lr)."""
    data, meta, path = _read(path)
    load_jax_params(model, _params(data, path))
    if opt_state is not None:
        pre = f"o::[{opt_state['index']}]"
        if f"{pre}.count" in data:
            opt_state["count"] = int(data[f"{pre}.count"])
        for k in opt_state["hyperparams"]:
            key = f"{pre}.hyperparams['{k}']"
            if key in data:
                opt_state["hyperparams"][k] = float(data[key])
        for mom in ("mu", "nu"):
            for name, t in opt_state[mom].items():
                key = f"{pre}.inner_state[0].{mom}{_keystr(name)}"
                if key in data:
                    if data[key].shape != tuple(t.shape):
                        raise ValueError(f"{path}: {key} is {data[key].shape}, "
                                         f"expected {tuple(t.shape)}")
                    with torch.no_grad():
                        t.copy_(torch.from_numpy(data[key]))
    return model, opt_state, meta.get("epoch", 0), meta.get("lr")
