"""The reference's torch checkpoints, read and written (counterpart of
cdlnet_tpu/compat/torch_ckpt.py).

A reference checkpoint is a torch.save dict {epoch, net_state_dict,
opt_state_dict, sched_state_dict} (train.py:221-247). Its weights are in
torch layout already, so import maps names and stacks the per-iteration
ModuleList entries along K into the JAX package's params pytree (numpy),
which compat/jax_params.load_jax_params copies into a model:

  CDLNet:        A.{k}.weight, B.{k}.weight -> A, B (K, M, C, P, P); t, g
  CDLNetVideo:   the same with 6-D weights and t, and
                 residual_blocks.{k}.conv{1,2}.weight -> residual.conv{1,2}
  GDLNet:        A.{k}.{alpha,a,w0,psi}, B.{k}.*; torch state dicts repeat
                 a shared parameter under every k, import keeps one (the
                 model's `shared` config) and export repeats it
  CDLNet_CSR:    + A2, B2, t2, g;  CDLNet_CSRf2: + g1, g2
  DnCNN/FFDNet:  dncnn.{i}.* Sequential indices (conv / BatchNorm / ReLU),
                 the running statistics as the (params, state) pair

Export writes the alias D.weight = B.0.weight the reference registers.
Adam's state is keyed by the index of each parameter in torch's
net.parameters() order (param_order) and maps onto optim.ClippedAdam's
mu, nu and count; StepLR's state onto the learning rate.
"""

from __future__ import annotations

import numpy as np
import torch

from cdlnet_tpu_torch.models import (
    CDLNet,
    CDLNetCSR,
    CDLNetCSRf2,
    CDLNetVideo,
    DnCNN,
    GDLNet,
)
from cdlnet_tpu_torch.train.optim import set_count, set_hyperparam

_GABOR = ("alpha", "a", "w0", "psi")


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _numpy_globals() -> list:
    """The numpy types a checkpoint of the JAX package's
    save_torch_checkpoint pickles (its Adam step is a numpy float32)."""
    core = np._core if hasattr(np, "_core") else np.core
    return [core.multiarray.scalar, np.dtype, type(np.dtype(np.float32))]


def load_torch_checkpoint(path: str) -> dict:
    """Read a reference .ckpt on the CPU with torch.load(weights_only=True):
    tensors, containers and the JAX package's numpy step scalars, nothing
    that runs code. Every tensor becomes numpy."""
    with torch.serialization.safe_globals(_numpy_globals()):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return _to_numpy(ckpt)


def _stack(sd: dict, fmt: str, K: int) -> np.ndarray:
    return np.stack([np.asarray(sd[fmt.format(k=k)]) for k in range(K)])


def _dncnn_index(model):
    """(number of middle layers, the last conv's Sequential index)."""
    nmid = model.K - 2
    return nmid, 2 + 3 * nmid


def import_net_state(model, state_dict: dict):
    """Map a torch net_state_dict onto the JAX params pytree of `model`
    (numpy arrays): a nested dict, or for DnCNN/FFDNet the (params, state)
    pair. Load it with compat.jax_params.load_jax_params."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    K = getattr(model, "K", None)
    if isinstance(model, (CDLNet, CDLNetVideo)):
        params = {"A": _stack(sd, "A.{k}.weight", K), "B": _stack(sd, "B.{k}.weight", K),
                  "t": sd["t"]}
        if isinstance(model, CDLNet):
            # registered but unused in the reference (model/net.py:36)
            params["g"] = sd.get("g", np.zeros_like(sd["t"]))
        elif model.residual is not None:
            params["residual"] = {c: _stack(sd, "residual_blocks.{k}." + c + ".weight", K)
                                  for c in ("conv1", "conv2")}
        return params
    if isinstance(model, GDLNet):
        params = {"t": sd["t"]}
        for bank in ("A", "B"):
            for name in _GABOR:
                key = f"{bank}_{name}"
                if not model._is_shared(name):
                    params[key] = _stack(sd, bank + ".{k}." + name, K)
                elif name == "alpha" and bank == "B":
                    params[key] = np.stack([sd["B.0.alpha"],
                                            sd["B.1.alpha" if K > 1 else "B.0.alpha"]])
                else:
                    params[key] = sd[f"{bank}.0.{name}"]
        return params
    if isinstance(model, CDLNetCSRf2):
        return {"A": _stack(sd, "A.{k}.weight", K), "B": _stack(sd, "B.{k}.weight", K),
                "t": sd["t"], "g1": sd["g1"], "g2": sd["g2"]}
    if isinstance(model, CDLNetCSR):
        params = {nm: _stack(sd, nm + ".{k}.weight", K) for nm in ("A", "B", "A2", "B2")}
        params.update(t=sd["t"], t2=sd["t2"], g=sd["g"])
        return params
    if isinstance(model, DnCNN):  # FFDNet too
        nmid, last = _dncnn_index(model)

        def mid(fmt):
            return np.stack([sd[fmt.format(i=i, c=2 + 3 * i, b=3 + 3 * i)]
                             for i in range(nmid)])

        params = {"w_in": sd["dncnn.0.weight"], "b_in": sd["dncnn.0.bias"],
                  "w_mid": mid("dncnn.{c}.weight"), "bn_scale": mid("dncnn.{b}.weight"),
                  "bn_bias": mid("dncnn.{b}.bias"), "w_out": sd[f"dncnn.{last}.weight"],
                  "b_out": sd[f"dncnn.{last}.bias"]}
        state = {"bn_mean": mid("dncnn.{b}.running_mean"),
                 "bn_var": mid("dncnn.{b}.running_var")}
        return params, state
    raise NotImplementedError(type(model).__name__)


def export_net_state(model) -> dict:
    """Inverse of import_net_state: the model's parameters (and running
    statistics) as a torch net_state_dict of numpy arrays, which the
    reference's load_state_dict takes."""
    p = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    K = getattr(model, "K", None)
    sd: dict = {}

    def unstack(fmt, arr):
        for k in range(arr.shape[0]):
            sd[fmt.format(k=k)] = arr[k]

    if isinstance(model, (CDLNet, CDLNetVideo, CDLNetCSR, CDLNetCSRf2)):
        banks = ("A", "B", "A2", "B2") if isinstance(model, CDLNetCSR) else ("A", "B")
        for nm in banks:
            unstack(nm + ".{k}.weight", p[nm])
        sd["D.weight"] = p["B"][0]  # the reference registers the alias
        for nm in ("t", "g", "t2", "g1", "g2"):
            if nm in p:
                sd[nm] = p[nm]
        if isinstance(model, CDLNetVideo) and model.residual is not None:
            for c in ("conv1", "conv2"):
                unstack("residual_blocks.{k}." + c + ".weight", p[f"residual.{c}"])
    elif isinstance(model, GDLNet):
        sd["t"] = p["t"]
        for bank in ("A", "B"):
            for name in _GABOR:
                v = p[f"{bank}_{name}"]
                if not model._is_shared(name):
                    unstack(bank + ".{k}." + name, v)
                elif name == "alpha" and bank == "B":
                    for k in range(K):
                        sd[f"B.{k}.alpha"] = v[min(k, 1)]
                else:
                    for k in range(K):
                        sd[f"{bank}.{k}.{name}"] = v
    elif isinstance(model, DnCNN):
        nmid, last = _dncnn_index(model)
        sd["dncnn.0.weight"], sd["dncnn.0.bias"] = p["w_in"], p["b_in"]
        for i in range(nmid):
            c, b = 2 + 3 * i, 3 + 3 * i
            sd[f"dncnn.{c}.weight"] = p["w_mid"][i]
            sd[f"dncnn.{b}.weight"] = p["bn_scale"][i]
            sd[f"dncnn.{b}.bias"] = p["bn_bias"][i]
            sd[f"dncnn.{b}.running_mean"] = p["bn_mean"][i]
            sd[f"dncnn.{b}.running_var"] = p["bn_var"][i]
            sd[f"dncnn.{b}.num_batches_tracked"] = np.asarray(0)
        sd[f"dncnn.{last}.weight"], sd[f"dncnn.{last}.bias"] = p["w_out"], p["b_out"]
    else:
        raise NotImplementedError(type(model).__name__)
    return sd


def param_order(model) -> list:
    """The reference nets' net.parameters() order as (name, index)
    addresses into the model's named parameters: the whole tensor when
    index is None, else row `index` of a stacked per-iteration tensor.

    torch.optim keys its per-parameter state by the index in the list
    handed to it, Adam(net.parameters()) (train.py:200). named_parameters
    yields a module's own parameters in registration order, then each
    submodule's, and keeps the first of aliased ones (D = B[0],
    net.py:34; GDLNet's shared Gabor parameters, net.py:607-622); the
    orders are the JAX package's, checked there against the reference's
    modules (tools/opt_state_gate.py)."""
    K = getattr(model, "K", None)

    def banks(*names):
        return [(nm, k) for nm in names for k in range(K)]

    if isinstance(model, CDLNetVideo):
        order = [("t", None)] + banks("A", "B")
        if model.residual is not None:
            for k in range(K):
                order += [("residual.conv1", k), ("residual.conv2", k)]
        return order
    if isinstance(model, CDLNet):
        return [("t", None), ("g", None)] + banks("A", "B")
    if isinstance(model, CDLNetCSRf2):
        return [("t", None), ("g1", None), ("g2", None)] + banks("A", "B")
    if isinstance(model, CDLNetCSR):
        return [("t", None), ("t2", None), ("g", None)] + banks("A", "B", "A2", "B2")
    if isinstance(model, GDLNet):
        # per-op Gabor parameters in ConvAdjoint2dGabor's registration
        # order (gabor.py:36-39), a shared one at its first owner: a, w0
        # and psi at op 0; alpha at A.0, and at B.0 and B.1 (B[0], the
        # dictionary, never shares alpha, net.py:611-613)
        order = [("t", None)]
        for bank in ("A", "B"):
            for k in range(K):
                for name in _GABOR:
                    if not model._is_shared(name):
                        order.append((f"{bank}_{name}", k))
                    elif name == "alpha":
                        if bank == "A" and k == 0:
                            order.append(("A_alpha", None))
                        elif bank == "B" and k <= 1:
                            order.append(("B_alpha", k))
                    elif k == 0:
                        order.append((f"{bank}_{name}", None))
        return order
    if isinstance(model, DnCNN):
        order = [("w_in", None), ("b_in", None)]
        for i in range(model.K - 2):
            order += [("w_mid", i), ("bn_scale", i), ("bn_bias", i)]
        return order + [("w_out", None), ("b_out", None)]
    raise NotImplementedError(type(model).__name__)


def _leaf(tensors: dict, addr) -> torch.Tensor:
    name, idx = addr
    return tensors[name] if idx is None else tensors[name][idx]


def import_opt_state(model, opt_sd: dict, opt_state: dict) -> dict:
    """Map a torch Adam opt_state_dict onto an optim.ClippedAdam state, in
    place, so a torch-trained run resumes with the same next update:
    exp_avg and exp_avg_sq onto mu and nu (the same update rule and bias
    correction), the step onto count, and the param group's lr, betas and
    eps onto the hyperparameters. Moments the torch state lacks (a
    parameter that never had a gradient) are zero, as torch starts them.
    Returns opt_state."""
    order = param_order(model)
    idxs = [i for g in opt_sd["param_groups"] for i in g["params"]]
    if len(idxs) != len(order):
        raise ValueError(f"the torch optimizer tracks {len(idxs)} parameters, "
                         f"{type(model).__name__} maps {len(order)}")
    tstate = opt_sd.get("state", {})
    step = 0
    with torch.no_grad():
        for mom in ("mu", "nu"):
            for t in opt_state[mom].values():
                t.zero_()
        for pos, addr in zip(idxs, order):
            st = tstate.get(pos, tstate.get(str(pos)))
            if st is None:
                continue
            for mom, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                dst = _leaf(opt_state[mom], addr)
                dst.copy_(torch.as_tensor(np.asarray(st[key])).reshape(dst.shape))
            step = max(step, int(np.asarray(st["step"])))
    set_count(opt_state, step)
    group = opt_sd["param_groups"][0]
    set_hyperparam(opt_state, "learning_rate", float(group["lr"]))
    if "betas" in group:
        for k, b in zip(("b1", "b2"), group["betas"]):
            set_hyperparam(opt_state, k, float(b))
    if "eps" in group:
        set_hyperparam(opt_state, "eps", float(group["eps"]))
    return opt_state


def export_opt_state(model, opt_state: dict) -> dict:
    """Inverse of import_opt_state: a torch Adam opt_state_dict (tensors on
    the CPU), so a checkpoint written here resumes in the reference with
    its moments."""
    order = param_order(model)
    step = torch.tensor(float(opt_state["count"]))
    state = {pos: {"step": step.clone(),
                   "exp_avg": _leaf(opt_state["mu"], addr).detach().cpu().clone(),
                   "exp_avg_sq": _leaf(opt_state["nu"], addr).detach().cpu().clone()}
             for pos, addr in enumerate(order)}
    hp = opt_state["hyperparams"]
    return {"state": state, "param_groups": [{
        "lr": float(hp["learning_rate"]),
        "betas": (float(hp["b1"]), float(hp["b2"])),
        "eps": float(hp["eps"]),
        "weight_decay": 0, "amsgrad": False, "maximize": False, "foreach": None,
        "capturable": False, "differentiable": False, "fused": None,
        "params": list(range(len(order))),
    }]}


def import_sched_state(sched_sd: dict | None) -> dict | None:
    """A torch StepLR sched_state_dict as {step_size, gamma, base_lr,
    last_epoch} (train.py:144-148); None when absent."""
    if not sched_sd:
        return None
    return {"step_size": int(sched_sd["step_size"]), "gamma": float(sched_sd["gamma"]),
            "base_lr": float(sched_sd["base_lrs"][0]),
            "last_epoch": int(sched_sd["last_epoch"])}


def sched_lr(sched_st: dict) -> float:
    """StepLR's learning rate at its last epoch."""
    return sched_st["base_lr"] * sched_st["gamma"] ** (
        sched_st["last_epoch"] // sched_st["step_size"])


def export_sched_state(sched: dict | None, lr: float, epoch: int) -> dict | None:
    """fit()'s sched ({step_size, gamma}) at learning rate lr after `epoch`
    epochs as a torch StepLR state dict."""
    if sched is None:
        return None
    gamma, step_size = float(sched["gamma"]), int(sched["step_size"])
    return {"step_size": step_size, "gamma": gamma,
            "base_lrs": [lr / gamma ** (epoch // step_size) if gamma else lr],
            "last_epoch": epoch, "_step_count": epoch + 1, "verbose": False,
            "_get_lr_called_within_step": False, "_last_lr": [lr]}


def save_torch_checkpoint(path: str, model, epoch: int = 0, opt_state: dict | None = None,
                          sched: dict | None = None, lr: float | None = None):
    """Write a reference-format .ckpt {epoch, net_state_dict,
    opt_state_dict, sched_state_dict} that the reference's torch code and
    the JAX package read. With opt_state the Adam moments go too, and lr
    defaults to its learning rate; sched (fit()'s StepLR spec) with lr
    gives the StepLR state."""
    opt_sd = None
    if opt_state is not None:
        opt_sd = export_opt_state(model, opt_state)
        if lr is None:
            lr = opt_sd["param_groups"][0]["lr"]
    sched_sd = export_sched_state(sched, lr, epoch) if lr is not None else None
    net = {k: torch.from_numpy(np.array(v)) for k, v in export_net_state(model).items()}
    torch.save({"epoch": epoch, "net_state_dict": net, "opt_state_dict": opt_sd,
                "sched_state_dict": sched_sd}, path)

