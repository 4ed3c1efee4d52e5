"""The port's torch .ckpt interop (compat/torch_ckpt.py) and background
checkpoint saving (train/checkpoint.py) on the CPU, against the JAX
package: .ckpt files of all seven families written by each package load in
the other with their Adam moments and step and their StepLR state;
init_model resumes a .ckpt as JAX's does; the entry points read .ckpt
files; a background save's side file is promoted when complete and
discarded when torn, and fit(ckpt_format="orbax") resumes."""

import json
import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu import compat as jax_compat
from cdlnet_tpu import models as jax_models
from cdlnet_tpu.compat.torch_ckpt import _find_adam
from cdlnet_tpu.train.fit import init_model as jax_init_model
from cdlnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from cdlnet_tpu_torch import models
from cdlnet_tpu_torch.compat import torch_ckpt
from cdlnet_tpu_torch.compat.jax_params import export_jax_params, load_jax_params
from cdlnet_tpu_torch.serve import Denoiser
from cdlnet_tpu_torch.train import checkpoint
from cdlnet_tpu_torch.train.checkpoint import load_ckpt, load_params, save_ckpt
from cdlnet_tpu_torch.train.fit import fit, init_model
from cdlnet_tpu_torch.train.fit_csr import fit_csr
from cdlnet_tpu_torch.train.optim import get_lr, make_optimizer

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
FAMILIES = {
    "CDLNet": dict(K=2, M=4, P=3, s=2, C=1, adaptive=True),
    "CDLNetVideo": dict(K=2, M=4, P=(3, 3, 3), s=2, C=1, adaptive=True, residual=True),
    "GDLNet": dict(K=3, M=4, P=5, s=2, C=1, order=2, shared="alpha_psi"),
    "CDLNet_CSR": dict(K=2, M=4, P=3, s=2, C=1, adaptive=True),
    "CDLNet_CSRf2": dict(K=2, M=4, P=3, s=2, C=1, adaptive=True),
    "DnCNN": dict(K=4, M=8),
    "FFDNet": dict(C=1, K=4, M=8),
}
SCHED = {"step_size": 2, "gamma": 0.5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    """A nested params dict as {'residual.conv1': array, ...}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_params_equal(ours, theirs):
    if isinstance(theirs, tuple):
        assert isinstance(ours, tuple)
        for a, b in zip(ours, theirs):
            _assert_params_equal(a, b)
        return
    a, b = _flat(ours), _flat(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_model(family):
    return jax_models.build_model(family, FAMILIES[family])


def _jax_trained(family, seed):
    """JAX params and a clipped-Adam state with seeded moments at count 2
    (set in place of two updates, which would compile op by op)."""
    jm = _jax_model(family)
    params = jm.init(jax.random.PRNGKey(seed), init=False)
    trainable = params[0] if isinstance(params, tuple) else params
    state = jax_make_optimizer(3e-3, clip_grad=1).init(trainable)
    rng = np.random.default_rng(seed)

    def moments():
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.uniform(0, 1, x.shape).astype(np.float32)), trainable)

    i, inj, j, adam = _find_adam(state)
    count = jnp.asarray(2, jnp.int32)
    adam = adam._replace(count=count, mu=moments(), nu=moments())
    inner = tuple(adam if jj == j else s for jj, s in enumerate(inj.inner_state))
    inj = inj._replace(count=count, inner_state=inner)
    return jm, params, tuple(inj if ii == i else s for ii, s in enumerate(state))


def _port_model(family, seed):
    """A port model with seeded weights (and statistics) and a ClippedAdam
    state with seeded moments at count 3."""
    model = models.build_model(family, FAMILIES[family])
    model.init(torch.Generator().manual_seed(seed), init=False)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for b in model.buffers():
            b.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, b.shape).astype(np.float32)))
    opt = make_optimizer(2e-3, clip_grad=1)
    state = opt.init(dict(model.named_parameters()))
    for mom in ("mu", "nu"):
        for t in state[mom].values():
            t.copy_(torch.from_numpy(rng.uniform(0, 1, t.shape).astype(np.float32)))
    state["count"] = 3
    return model, opt, state


def _assert_moments_equal(port_state, jax_state):
    _, inj, _, adam = _find_adam(jax_state)
    for mom in ("mu", "nu"):
        theirs = _flat(_np(getattr(adam, mom)))
        ours = {k: v.numpy() for k, v in port_state[mom].items()}
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=f"{mom} {k}")
    assert port_state["count"] == int(adam.count)
    assert get_lr(port_state) == pytest.approx(float(inj.hyperparams["learning_rate"]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jax_ckpt_loads_in_the_port(family, tmp_path):
    """JAX's save_torch_checkpoint -> the port's load_torch_checkpoint
    (weights_only), import_net_state, import_opt_state and
    import_sched_state: equal params (and statistics), moments, step, lr."""
    jm, params, jstate = _jax_trained(family, seed=1)
    path = str(tmp_path / "j.ckpt")
    jax_compat.save_torch_checkpoint(path, jm, params, epoch=4, opt_state=jstate,
                                     sched=SCHED, lr=7.5e-4)
    ckpt = torch_ckpt.load_torch_checkpoint(path)
    assert ckpt["epoch"] == 4
    model = models.build_model(family, FAMILIES[family])
    load_jax_params(model, torch_ckpt.import_net_state(model, ckpt["net_state_dict"]))
    _assert_params_equal(export_jax_params(model), _np(params))
    state = make_optimizer(1e-3, clip_grad=1).init(dict(model.named_parameters()))
    torch_ckpt.import_opt_state(model, ckpt["opt_state_dict"], state)
    _assert_moments_equal(state, jstate)
    sched = torch_ckpt.import_sched_state(ckpt["sched_state_dict"])
    assert sched == jax_compat.import_sched_state(ckpt["sched_state_dict"])
    assert torch_ckpt.sched_lr(sched) == pytest.approx(7.5e-4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_ckpt_loads_in_jax(family, tmp_path):
    """The port's save_torch_checkpoint -> JAX's load_torch_checkpoint,
    import_net_state, import_opt_state and import_sched_state."""
    model, _, state = _port_model(family, seed=2)
    path = str(tmp_path / "p.ckpt")
    torch_ckpt.save_torch_checkpoint(path, model, epoch=6, opt_state=state, sched=SCHED)
    ckpt = jax_compat.load_torch_checkpoint(path)
    jm = _jax_model(family)
    params = _np(jax_compat.import_net_state(jm, ckpt["net_state_dict"]))
    _assert_params_equal(export_jax_params(model), params)
    trainable = params[0] if isinstance(params, tuple) else params
    jopt = jax_make_optimizer(1e-3, clip_grad=1)
    jstate = jax_compat.import_opt_state(jm, ckpt["opt_state_dict"], jopt.init(trainable),
                                         trainable)
    _assert_moments_equal(state, jstate)
    assert jax_compat.import_sched_state(ckpt["sched_state_dict"]) == {
        "step_size": 2, "gamma": 0.5, "base_lr": 2e-3 / 0.5 ** 3, "last_epoch": 6}
    # the reference's own optimizer takes the state dict as it is
    tparams = [torch.nn.Parameter(torch.zeros(())) for _ in torch_ckpt.param_order(model)]
    torch.optim.Adam(tparams).load_state_dict(torch.load(path)["opt_state_dict"])


def _args(family, ckpt, lr=1e-3):
    return {"type": family, "model": dict(FAMILIES[family], init=False),
            "paths": {"ckpt": ckpt, "save": os.path.dirname(ckpt)},
            "train": {"opt": {"lr": lr}, "fit": {"clip_grad": 1}}}


@pytest.mark.parametrize("with_opt", [True, False], ids=["adam", "steplr"])
@pytest.mark.parametrize("family", ["CDLNetVideo", "DnCNN"])
def test_init_model_resumes_a_ckpt_as_jax_does(family, with_opt, tmp_path):
    """init_model on a .ckpt: the epoch, the weights, the Adam moments and
    lr of its opt_state_dict, or without one StepLR's lr, as JAX's
    init_model gives them."""
    jm, params, jstate = _jax_trained(family, seed=3)
    path = str(tmp_path / "net.ckpt")
    jax_compat.save_torch_checkpoint(path, jm, params, epoch=5,
                                     opt_state=jstate if with_opt else None,
                                     sched=SCHED, lr=2.5e-4)
    _, jparams, _, jst, jepoch, jlr = jax_init_model(_args(family, path))
    model, _, state, epoch, lr = init_model(_args(family, path), device="cpu")
    assert epoch == jepoch == 5 and lr == pytest.approx(jlr)
    assert get_lr(state) == pytest.approx(float(_find_adam(jst)[1].hyperparams["learning_rate"]))
    _assert_params_equal(export_jax_params(model), _np(jparams))
    _assert_moments_equal(state, jst)


def test_load_params_and_denoiser_read_a_ckpt(tmp_path):
    """load_params maps a .ckpt through the model config (and says so
    without one); Denoiser.from_dir serves a .ckpt export of the video and
    CSR demos bitwise as it serves their .npz bundles."""
    model, _, _ = _port_model("DnCNN", seed=4)
    path = str(tmp_path / "d.ckpt")
    torch_ckpt.save_torch_checkpoint(path, model, epoch=1)
    with pytest.raises(ValueError, match="model config"):
        load_params(path)
    params, meta = load_params(path, models.DnCNN(**FAMILIES["DnCNN"]))
    assert meta["epoch"] == 1
    _assert_params_equal(params, export_jax_params(model))

    rng = np.random.default_rng(5)
    for demo in ("cdlnet-video-demo", "csr-demo"):
        npz = Denoiser.from_dir(os.path.join(EXAMPLES, demo), device="cpu")
        out = tmp_path / demo
        shutil.copytree(os.path.join(EXAMPLES, demo), out,
                        ignore=shutil.ignore_patterns("*.png", "filters"))
        torch_ckpt.save_torch_checkpoint(str(out / "net.ckpt"), npz.model, epoch=150)
        with open(out / "args.json") as f:
            args = json.load(f)
        args["paths"]["ckpt"] = str(out / "net.ckpt")
        with open(out / "args.json", "w") as f:
            json.dump(args, f)
        ck = Denoiser.from_dir(str(out), device="cpu")
        clip = rng.uniform(size=(4, 32, 32)).astype(np.float32)
        np.testing.assert_array_equal(ck.denoise_video(clip, sigma=25),
                                      npz.denoise_video(clip, sigma=25))


def test_load_torch_checkpoint_is_weights_only(tmp_path):
    path = str(tmp_path / "x.ckpt")
    torch.save({"epoch": 1, "hook": shutil.copy}, path)
    with pytest.raises(Exception, match="[Ww]eights only"):
        torch_ckpt.load_torch_checkpoint(path)


def test_side_file_is_promoted_when_complete_and_discarded_when_torn(tmp_path):
    """A side file a dead process left: complete, the next load promotes
    it; torn, the next load deletes it and reads the bundle it would have
    replaced. A background save is read back after it settles."""
    model, opt, state = _port_model("CDLNet", seed=6)
    base = str(tmp_path / "net.ckpt")
    save_ckpt(base, model, 1, state, 1e-3)
    newer, _, _ = _port_model("CDLNet", seed=7)
    save_ckpt(str(tmp_path / "other"), newer, 2)
    os.replace(str(tmp_path / "other.npz"), base + ".npz.new")
    back = models.CDLNet(**FAMILIES["CDLNet"])
    _, _, epoch, _ = load_ckpt(base, back)
    assert epoch == 2 and not os.path.exists(base + ".npz.new")
    assert torch.equal(back.A, newer.A)

    data = open(base + ".npz", "rb").read()
    with open(base + ".npz.new", "wb") as f:
        f.write(data[: len(data) // 2])
    _, _, epoch, _ = load_ckpt(base, back)
    assert epoch == 2 and not os.path.exists(base + ".npz.new")

    save_ckpt(base, model, 3, state, 5e-4, background=True)
    _, _, epoch, lr = load_ckpt(base, back)
    assert (epoch, lr) == (3, 5e-4) and torch.equal(back.A, model.A)
    assert not os.path.exists(base + ".npz.new") and not checkpoint._PENDING


def test_background_save_snapshots_before_it_returns(tmp_path, monkeypatch):
    """The tensors are copied to host before save_ckpt returns: an in-place
    update right after it does not reach the bundle being written."""
    model, _, _ = _port_model("DnCNN", seed=8)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    save_ckpt(str(tmp_path / "net.ckpt"), model, 1, background=True)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.add_(1.0)
    checkpoint.wait_for_checkpoints()
    back = models.DnCNN(**FAMILIES["DnCNN"])
    load_ckpt(str(tmp_path / "net.ckpt"), back)
    assert all(torch.equal(want[k], v) for k, v in back.state_dict().items())


def test_fit_orbax_format_resumes(tmp_path):
    """fit(ckpt_format="orbax") leaves promoted .npz bundles (no side file)
    that init_model resumes from; fit_csr takes the format too."""
    batches = [np.random.default_rng(s).uniform(size=(2, 1, 12, 12)).astype(np.float32)
               for s in range(2)]
    loaders = {"train": batches, "val": batches[:1], "test": batches[:1]}
    args = _args("DnCNN", str(tmp_path / "net.ckpt"))
    model, opt, state, epoch0, _ = init_model(args, device="cpu")
    assert epoch0 == 0
    fit(model, opt, state, loaders, save_dir=str(tmp_path), epochs=2, noise_std=25,
        workload="2d", ckpt_format="orbax", backtrack_thresh=None, verbose=False)
    assert sorted(f for f in os.listdir(tmp_path) if "ckpt" in f) == [
        "0.ckpt.npz", "net.ckpt.npz"]
    back, _, back_state, epoch, _ = init_model(args, device="cpu")
    assert epoch == 2 and back_state["count"] == 4
    for a, b in zip(model.state_dict().values(), back.state_dict().values()):
        assert torch.equal(a, b)
    _, history = fit(back, opt, back_state, loaders, save_dir=str(tmp_path), epochs=1,
                     start_epoch=epoch + 1, noise_std=25, workload="2d",
                     ckpt_format="orbax", backtrack_thresh=None, verbose=False)
    assert [e for e, _, _ in history] == [3, 3]
    with pytest.raises(ValueError, match="ckpt_format"):
        fit(back, opt, back_state, loaders, save_dir=str(tmp_path), ckpt_format="zarr")

    csr = models.build_model("CDLNet_CSRf2", FAMILIES["CDLNet_CSRf2"])
    csr.init(torch.Generator().manual_seed(0), init=False)
    copt = make_optimizer(1e-3)
    vols = [np.random.default_rng(9).uniform(size=(1, 1, 3, 8, 8)).astype(np.float32)]
    fit_csr(csr, copt, copt.init(dict(csr.named_parameters())),
            {"train": vols, "val": vols, "test": vols}, save_dir=str(tmp_path / "csr"),
            ckpt_format="orbax", verbose=False)
    assert sorted(os.listdir(tmp_path / "csr")).count("net_epoch_1.ckpt.npz") == 1
    assert not [f for f in os.listdir(tmp_path / "csr") if f.endswith(".new")]
