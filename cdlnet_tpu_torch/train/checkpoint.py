"""The JAX package's native .npz checkpoints, written and read (counterpart
of cdlnet_tpu/train/checkpoint.py), and the reference's torch .ckpt files
read through compat/torch_ckpt.py.

A bundle holds path-flattened params under 'p::' keys written by
jax.tree_util.keystr, e.g. "p::['A']" or "p::['residual']['conv1']" (a
stateful family's (params, state) pair as "p::[0]['w_in']" and
"p::[1]['bn_mean']"), optimizer leaves under 'o::' keys of optax's state
(with clipping, the Adam state is entry 1 of the chain: "o::[1].count",
"o::[1].hyperparams['learning_rate']", "o::[1].inner_state[0].mu['A']",
...), and a JSON 'meta::json' blob (epoch, lr). Bundles written here load
in the JAX package and the other way round.

save_ckpt(..., background=True) does the job of the JAX package's orbax
backend on .npz files: it snapshots the tensors to host memory, writes the
bundle on a thread to a side file <final>.new, and promotes the side file
over <final> by os.replace once it is complete, when the next save of that
path, wait_for_checkpoints() or any restore settles it. A side file left by
a process that died is promoted at the next restore if it is a complete
zip, and discarded if it is torn; so a complete bundle exists at every
instant. Orbax directories are not read: that needs orbax, which imports
jax.
"""

from __future__ import annotations

import functools
import json
import os
import re
import threading
import zipfile

import numpy as np
import torch

from cdlnet_tpu_torch.compat.jax_params import is_stateful, load_jax_params
from cdlnet_tpu_torch.train.optim import set_count, set_hyperparam

_KEY = re.compile(r"\['([^']*)'\]")
_BUNDLE = re.compile(r"^\[([01])\]")
TORCH_EXTS = (".ckpt", ".pt", ".pth")
# final path -> (writer thread, the writer's error list)
_PENDING: dict = {}


def _final(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _side_complete(side: str) -> bool:
    try:
        with zipfile.ZipFile(side) as z:
            return z.testzip() is None
    except (zipfile.BadZipFile, OSError):
        return False


def _promote(final: str):
    """Fold a side file left over (by a process that died) into final: a
    complete one replaces it, a torn one is deleted."""
    side = final + ".new"
    if os.path.exists(side):
        if _side_complete(side):
            os.replace(side, final)
        else:
            os.remove(side)


def _settle(final: str):
    """Wait for the background write of final, if any, and promote it."""
    pending = _PENDING.pop(final, None)
    if pending is not None:
        thread, errors = pending
        thread.join()
        if errors:
            if os.path.exists(final + ".new"):
                os.remove(final + ".new")
            raise errors[0]
        os.replace(final + ".new", final)


def wait_for_checkpoints():
    """Block until every background save has written its side file, and
    promote each. Call before exit or before reading a checkpoint another
    way; every restore here does it itself."""
    for final in list(_PENDING):
        _settle(final)


def settles_checkpoints(fn):
    """Decorate a training loop so that its background saves are settled
    (wait_for_checkpoints) when it returns and when it raises."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        finally:
            wait_for_checkpoints()
    return wrapper


def _resolve(path: str) -> str:
    """The bundle a path names: path itself when it ends in .npz, else
    path + '.npz' (fit's "net.ckpt" -> "net.ckpt.npz") or, failing that,
    path. Pending and leftover side files are settled first."""
    for cand in ((path,) if path.endswith(".npz") else (path + ".npz", path)):
        if cand.endswith(".npz"):
            _settle(cand)
            _promote(cand)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(path)


def is_torch_ckpt(path: str) -> bool:
    """Whether path is a reference torch checkpoint: a file that exists
    under a torch name (.ckpt, .pt, .pth). Any other path names an .npz
    bundle (path or path + '.npz')."""
    return str(path).endswith(TORCH_EXTS) and os.path.isfile(path)


def _read(path: str) -> tuple[dict, dict, str]:
    """(all arrays by key, meta, resolved path) of an .npz bundle."""
    path = _resolve(path)
    if path.endswith(".orbax") or os.path.isdir(path):
        raise ValueError(f"{path}: orbax checkpoint directories need orbax, which "
                         "imports jax; cdlnet_tpu_torch reads .npz bundles and .ckpt files")
    with np.load(path) as data:
        data = dict(data)
    meta = json.loads(bytes(data.pop("meta::json"))) if "meta::json" in data else {}
    return data, meta, path


def load_params(path: str, model=None) -> tuple:
    """Read (params, meta): params as a nested dict of numpy arrays keyed
    like the JAX params pytree (for a stateful family the (params, state)
    pair), meta the JSON blob (epoch, lr, ...). A reference torch .ckpt
    maps its net state through the model config `model`
    (compat.torch_ckpt.import_net_state; meta holds its epoch)."""
    if is_torch_ckpt(path):
        from cdlnet_tpu_torch.compat.torch_ckpt import import_net_state, load_torch_checkpoint

        if model is None:
            raise ValueError(f"{path}: a torch checkpoint's net state maps onto "
                             "params only through a model config: pass model=")
        ckpt = load_torch_checkpoint(path)
        return import_net_state(model, ckpt["net_state_dict"]), {"epoch": ckpt.get("epoch")}
    data, meta, path = _read(path)
    return _params(data, path), meta


def _params(data: dict, path: str):
    trees = {}
    for key, arr in data.items():
        if not key.startswith("p::"):
            continue
        rest = key[3:]
        m = _BUNDLE.match(rest)
        part = int(m.group(1)) if m else None
        rest = rest[m.end():] if m else rest
        names = _KEY.findall(rest)
        if not names or "".join(f"['{n}']" for n in names) != rest:
            raise ValueError(f"{path}: unsupported params key {key!r}")
        node = trees.setdefault(part, {})
        for name in names[:-1]:
            node = node.setdefault(name, {})
        node[names[-1]] = arr
    if None in trees:
        if len(trees) > 1:
            raise ValueError(f"{path}: mixes plain and (params, state) keys")
        return trees[None]
    return trees.get(0, {}), trees.get(1, {})


def _keystr(name: str) -> str:
    """A module state name ('A', 'residual.conv1') as jax keystr ("['A']")."""
    return "".join(f"['{n}']" for n in name.split("."))


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of t, taken now (a CPU tensor's numpy view would follow
    later in-place updates)."""
    return t.detach().to("cpu", copy=True).numpy()


def _number(v):
    """A host number for a 0-d tensor (optim's device scalars) or a number."""
    return v.item() if isinstance(v, torch.Tensor) else v


def _opt_leaves(opt_state: dict) -> dict:
    """optax's npz keys -> numpy leaves of an optim.ClippedAdam state: the
    inject_hyperparams state (count, hyperparams) around the Adam state."""
    pre = f"o::[{opt_state['index']}]"
    count = np.asarray(_number(opt_state["count"]), np.int32)
    out = {f"{pre}.count": count, f"{pre}.inner_state[0].count": count}
    for k, v in opt_state["hyperparams"].items():
        out[f"{pre}.hyperparams['{k}']"] = np.asarray(v, np.float32)
    for mom in ("mu", "nu"):
        for name, t in opt_state[mom].items():
            out[f"{pre}.inner_state[0].{mom}{_keystr(name)}"] = _host(t)
    return out


def _model_leaves(model) -> dict:
    """The model's params (and a stateful family's buffers) under 'p::'
    keys, as the JAX package writes its params or (params, state) pytree."""
    if not is_stateful(model):
        return {"p::" + _keystr(k): _host(v) for k, v in model.state_dict().items()}
    out = {f"p::[0]{_keystr(k)}": _host(v) for k, v in model.named_parameters()}
    out.update({f"p::[1]{_keystr(k)}": _host(v) for k, v in model.named_buffers()})
    return out


def _write(target: str, data: dict):
    with open(target, "wb") as f:
        np.savez(f, **data)


def save_ckpt(path: str, model, epoch: int = 0, opt_state=None, lr=None,
              extra: dict = None, background: bool = False):
    """Save the model's params (+ running statistics, + optimizer state) to
    an .npz bundle, atomically: written beside it, then renamed over
    <path>, so a crash mid-write never clobbers the previous complete
    bundle. background=True returns once the tensors are snapshotted and
    writes on a thread (the module docstring)."""
    data = _model_leaves(model)
    if opt_state is not None:
        data.update(_opt_leaves(opt_state))
    meta = {"epoch": epoch, "lr": lr}
    if extra:
        meta.update(extra)
    data["meta::json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    final = _final(path)
    _settle(final)
    if not background:
        tmp = final + ".tmp.npz"
        _write(tmp, data)
        os.replace(tmp, final)
        return
    _promote(final)  # a side file a dead process left
    errors: list = []

    def write():
        try:
            _write(final + ".new", data)
        except BaseException as e:  # noqa: BLE001 - re-raised when settled
            errors.append(e)

    thread = threading.Thread(target=write, name="save_ckpt")
    thread.start()
    _PENDING[final] = (thread, errors)


def save_args(args: dict, save_dir: str, ckpt_name: str = "net.ckpt.npz"):
    """Re-serialize the args.json into the save dir with the ckpt path patched
    in, sorted keys (reference train.py:249-258)."""
    args = json.loads(json.dumps(args))  # deep copy
    args.setdefault("paths", {})["ckpt"] = os.path.join(save_dir, ckpt_name)
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "args.json"), "w") as f:
        f.write(json.dumps(args, indent=4, sort_keys=True))


def load_ckpt(path: str, model, opt_state=None):
    """Restore an .npz bundle into `model` (strictly, in place: a stateful
    family's running statistics too) and, when given, into opt_state (in
    place; leaves the bundle lacks keep their values, as in the JAX
    package). Returns (model, opt_state, epoch, lr)."""
    data, meta, path = _read(path)
    load_jax_params(model, _params(data, path))
    if opt_state is not None:
        pre = f"o::[{opt_state['index']}]"
        if f"{pre}.count" in data:
            set_count(opt_state, int(data[f"{pre}.count"]))
        for k in opt_state["hyperparams"]:
            key = f"{pre}.hyperparams['{k}']"
            if key in data:
                set_hyperparam(opt_state, k, float(data[key]))
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
