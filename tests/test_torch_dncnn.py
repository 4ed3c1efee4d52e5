"""The port's DnCNN and FFDNet (models/dncnn.py) and their stateful
training on the CPU, against the reference goldens and the JAX package:
the forward in eval and train mode with the running statistics, one
stateful train step, the npz (params, state) bundle both ways, fit's
checkpoints of the statistics, init_model and Denoiser on the statistics."""

import importlib
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu import nle as jax_nle
from cdlnet_tpu.compat import import_net_state as jax_import_net_state
from cdlnet_tpu.models import DnCNN as JaxDnCNN
from cdlnet_tpu.models import FFDNet as JaxFFDNet
from cdlnet_tpu.train import checkpoint as jax_ckpt
from cdlnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from cdlnet_tpu_torch.cli import train as cli_train
from cdlnet_tpu_torch.compat.jax_params import export_jax_params, is_stateful, load_jax_params
from cdlnet_tpu_torch.compat.torch_ckpt import import_net_state
from cdlnet_tpu_torch.models import CDLNet, DnCNN, FFDNet
from cdlnet_tpu_torch.models.base import build_model, resolve_backend
from cdlnet_tpu_torch.serve import Denoiser
from cdlnet_tpu_torch.train import fit as fit_mod
from cdlnet_tpu_torch.train.checkpoint import load_ckpt, load_params, save_ckpt
from cdlnet_tpu_torch.train.fit import fit, init_model, make_train_step
from cdlnet_tpu_torch.train.optim import get_lr, make_optimizer

# the module (cdlnet_tpu.train re-exports the function fit under its name)
jax_fit = importlib.import_module("cdlnet_tpu.train.fit")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = 1e-5
FAMILIES = {
    "DnCNN": (JaxDnCNN, DnCNN, dict(K=4, M=8)),
    "FFDNet": (JaxFFDNet, FFDNet, dict(C=1, K=4, M=8)),
}


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


def _bundle(jax_model, seed):
    """JAX init params with non-trivial BatchNorm scale, shift and running
    statistics, as a numpy (params, state) pair."""
    params, state = _np(jax_model.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params["bn_scale"] = rng.uniform(0.5, 1.5, params["bn_scale"].shape).astype(np.float32)
    params["bn_bias"] = rng.uniform(-0.1, 0.1, params["bn_bias"].shape).astype(np.float32)
    state = {"bn_mean": rng.uniform(-0.2, 0.2, state["bn_mean"].shape).astype(np.float32),
             "bn_var": rng.uniform(0.2, 2.0, state["bn_var"].shape).astype(np.float32)}
    return params, state


def _pair(family, seed=0):
    jax_cls, cls, cfg = FAMILIES[family]
    jm = jax_cls(**cfg)
    bundle = _bundle(jm, seed)
    return jm, bundle, load_jax_params(cls(**cfg), bundle)


def _images(shape, seed=1):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", ["dncnn", "ffdnet"])
def test_golden_through_import_net_state(name):
    """The reference torch forward (sd:: state dict, eval mode) through the
    port's import_net_state."""
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    sd = {k[4:]: data[k] for k in data.files if k.startswith("sd::")}
    model = DnCNN(K=5, M=8) if name == "dncnn" else FFDNet(C=1, K=5, M=8)
    load_jax_params(model, import_net_state(model, sd)).eval()
    x = torch.from_numpy(data["x"])
    with torch.no_grad():
        out = model(x) if name == "dncnn" else model(x, float(data["sigma"]))
    np.testing.assert_allclose(out[0].numpy(), data["xhat"], atol=TOL)
    if name == "dncnn":
        np.testing.assert_allclose(out[1].numpy(), data["n"], atol=TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_matches_jax(family, train):
    """Both outputs and the running statistics after the forward: eval mode
    on the running statistics (unchanged), train mode on the batch's (the
    statistics updated in place in the stacked buffers). FFDNet at an odd
    size (reflect pad to even) with one sigma per image."""
    jm, bundle, model = _pair(family)
    y = _images((3, 1, 15, 18))
    sigma = np.array([10.0, 25.0, 40.0], np.float32)
    s_j = jnp.asarray(sigma) if family == "FFDNet" else None
    (x_j, n_j), st_j = jm.apply(bundle[0], jnp.asarray(y), s_j, state=bundle[1], train=train)
    model.train(train)
    with torch.no_grad():
        x_t, n_t = model(torch.from_numpy(y), torch.from_numpy(sigma))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=TOL)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=TOL)
    for k in ("bn_mean", "bn_var"):
        np.testing.assert_allclose(getattr(model, k).numpy(), np.asarray(st_j[k]), atol=TOL)
    moved = not np.allclose(model.bn_mean.numpy(), bundle[1]["bn_mean"])
    assert moved == train


def test_ffdnet_scalar_and_missing_sigma_match_jax():
    jm, bundle, model = _pair("FFDNet", seed=2)
    model.eval()
    y = _images((2, 1, 16, 14), seed=3)
    for sigma in (25.0, None):
        (x_j, m_j), _ = jm.apply(bundle[0], jnp.asarray(y), sigma, state=bundle[1])
        with torch.no_grad():
            x_t, m_t = model(torch.from_numpy(y), sigma)
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=TOL)
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_draws_the_jax_bounds(family):
    """Conv weights uniform in +-1/sqrt(fan_in) from the seed, biases and
    shifts 0, scales 1, fresh running statistics; the same on a rerun."""
    _, cls, cfg = FAMILIES[family]
    model = cls(**cfg).init(torch.Generator().manual_seed(0))
    P2 = model.P ** 2
    for name, fan_in in (("w_in", model.Ci * P2), ("w_mid", model.M * P2),
                         ("w_out", model.M * P2)):
        w = getattr(model, name)
        assert w.abs().max() <= fan_in ** -0.5 and w.std() > 0.2 * fan_in ** -0.5
    for name, val in (("b_in", 0), ("bn_bias", 0), ("b_out", 0), ("bn_scale", 1),
                      ("bn_mean", 0), ("bn_var", 1)):
        assert torch.equal(getattr(model, name), torch.full_like(getattr(model, name), val))
    again = cls(**cfg).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    assert is_stateful(model) and not is_stateful(CDLNet(K=2, M=4, P=3))
    assert model.project() is model


def _fixed_noise(noisy, sigma):
    """An awgn for both packages that returns the given noisy batch."""
    def jax_awgn(key, x, nstd):
        return jnp.asarray(noisy), jnp.asarray(sigma)

    def torch_awgn(x, nstd, generator=None):
        return torch.from_numpy(noisy), torch.from_numpy(sigma)

    return jax_awgn, torch_awgn


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stateful_train_step_matches_jax(family, monkeypatch):
    """One step of JAX's make_train_step(stateful=True) and the port's on
    the same noisy batch: the loss, every parameter after the clipped Adam
    update and the running statistics; then the eval step on the updated
    statistics, which it leaves as they are."""
    jm, bundle, model = _pair(family, seed=4)
    clean = _images((3, 1, 12, 12), seed=5)
    sigma = np.array([20.0, 25.0, 30.0], np.float32).reshape(3, 1, 1, 1)
    noisy = (clean + sigma / 255 * np.random.default_rng(6).standard_normal(clean.shape)
             ).astype(np.float32)
    jax_awgn, torch_awgn = _fixed_noise(noisy, sigma)
    monkeypatch.setattr(jax_fit, "awgn", jax_awgn)
    monkeypatch.setattr(fit_mod, "awgn", torch_awgn)

    jopt = jax_make_optimizer(1e-3, clip_grad=0.05)
    jstep, jeval = jax_fit.make_train_step(jm, jopt, workload="2d", noise_std=(20, 30),
                                           stateful=True)
    params, state = jax.tree_util.tree_map(jnp.asarray, bundle)
    params, state, _, loss_j = jstep(params, state, jopt.init(params), jnp.asarray(clean),
                                     jax.random.PRNGKey(0))
    eval_j = jeval(params, state, jnp.asarray(clean), jax.random.PRNGKey(1))

    opt = make_optimizer(1e-3, clip_grad=0.05)
    opt_state = opt.init(dict(model.named_parameters()))
    step, evals = make_train_step(model, opt, workload="2d", noise_std=(20, 30))
    loss_t = step(opt_state, torch.from_numpy(clean), None)
    assert model.training
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=TOL)
    got_p, got_s = export_jax_params(model)
    for k, v in got_p.items():
        np.testing.assert_allclose(v, np.asarray(params[k]), atol=TOL, err_msg=k)
    for k, v in got_s.items():
        np.testing.assert_allclose(v, np.asarray(state[k]), atol=TOL, err_msg=k)
    stats = [b.clone() for b in model.buffers()]
    eval_t = evals(torch.from_numpy(clean), None)
    assert not model.training
    np.testing.assert_allclose(float(eval_t), float(eval_j), rtol=TOL)
    assert all(torch.equal(a, b) for a, b in zip(stats, model.buffers()))


def test_stateful_flag_must_match_the_model():
    opt = make_optimizer(1e-3)
    with pytest.raises(ValueError, match="running statistics"):
        make_train_step(DnCNN(K=3, M=4), opt, workload="2d", stateful=False)
    with pytest.raises(ValueError, match="running statistics"):
        make_train_step(CDLNet(K=2, M=4, P=3), opt, workload="2d", stateful=True)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_npz_bundle_loads_in_both_packages(family, tmp_path):
    """A stateful family's bundle keys its leaves "p::[0]['w_in']" and
    "p::[1]['bn_mean']": the port's loads in JAX's load_ckpt with a (params,
    state) template and the Adam state, and JAX's in the port's."""
    jm, bundle, model = _pair(family, seed=7)
    opt = make_optimizer(5e-4, clip_grad=1)
    opt_state = opt.init(dict(model.named_parameters()))
    for t in opt_state["mu"].values():
        t.fill_(0.25)
    opt_state["count"] = 3
    save_ckpt(str(tmp_path / "p"), model, 5, opt_state, 5e-4)
    keys = np.load(tmp_path / "p.npz").files
    assert "p::[0]['w_in']" in keys and "p::[1]['bn_var']" in keys
    jopt = jax_make_optimizer(1e-3, clip_grad=1)
    tmpl = jax.tree_util.tree_map(jnp.asarray, _bundle(jm, 8))
    (jp, js), jst, epoch, lr = jax_ckpt.load_ckpt(str(tmp_path / "p"), tmpl,
                                                  jopt.init(tmpl[0]))
    assert epoch == 5 and lr == pytest.approx(5e-4)
    assert int(jst[1].count) == 3
    np.testing.assert_array_equal(np.asarray(jst[1].inner_state[0].mu["w_mid"]), 0.25)
    for ours, theirs in zip(bundle, (jp, js)):
        for k, v in ours.items():
            np.testing.assert_array_equal(np.asarray(theirs[k]), v)

    jax_bundle = jax.tree_util.tree_map(jnp.asarray, _bundle(jm, 9))
    jax_ckpt.save_ckpt(str(tmp_path / "j"), jax_bundle, 2, jopt.init(jax_bundle[0]), 1e-3)
    back = FAMILIES[family][1](**FAMILIES[family][2])
    _, _, epoch, lr = load_ckpt(str(tmp_path / "j"), back)
    assert epoch == 2 and lr == pytest.approx(1e-3)
    for ours, theirs in zip(export_jax_params(back), _np(jax_bundle)):
        for k, v in theirs.items():
            np.testing.assert_array_equal(ours[k], v)
    params, meta = load_params(str(tmp_path / "j"))
    assert isinstance(params, tuple) and meta["epoch"] == 2


def _args(tmp_path, family, **model):
    return {"type": family, "model": dict(FAMILIES[family][2], **model),
            "paths": {"save": str(tmp_path)},
            "train": {"opt": {"lr": 1e-3}, "fit": {"clip_grad": 0.05}}}


def test_fit_checkpoints_and_restores_the_statistics(tmp_path, monkeypatch):
    """fit trains the running statistics with the parameters; its
    checkpoint holds both and reloads them bitwise; a backtrack restores
    the statistics of the checkpoint it reads."""
    model = DnCNN(K=4, M=8).init(torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3, clip_grad=0.05)
    opt_state = opt.init(dict(model.named_parameters()))
    batches = [_images((4, 1, 12, 12), seed=s) for s in range(2)]
    loaders = {"train": batches, "val": batches[:1], "test": batches[:1]}
    fit(model, opt, opt_state, loaders, save_dir=str(tmp_path), epochs=2, noise_std=25,
        workload="2d", backtrack_thresh=None, verbose=False)
    assert not torch.equal(model.bn_mean, torch.zeros_like(model.bn_mean))
    back = DnCNN(K=4, M=8)
    load_ckpt(str(tmp_path / "net.ckpt"), back)
    for a, b in zip(model.state_dict().values(), back.state_dict().values()):
        assert torch.equal(a, b)

    class NanOnce:
        """A NaN batch on the first pass (a backtrack to 0.ckpt), then data."""
        passes = 0

        def __iter__(self):
            NanOnce.passes += 1
            yield np.full((4, 1, 12, 12), np.nan, np.float32) if NanOnce.passes == 1 \
                else batches[0]

    restored = []

    def spy(path, m, state=None):
        out = load_ckpt(path, m, state)
        restored.append({k: v.clone() for k, v in m.state_dict().items()})
        return out

    monkeypatch.setattr(fit_mod, "load_ckpt", spy)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    fit(model, opt, opt_state, {"train": NanOnce(), "val": [], "test": []},
        save_dir=str(tmp_path / "nan"), epochs=1, noise_std=25, workload="2d",
        backtrack_thresh=1, verbose=False)
    assert len(restored) == 1 and NanOnce.passes == 2
    assert all(torch.equal(restored[0][k], v) for k, v in start.items())
    assert not torch.equal(model.bn_mean, start["bn_mean"])


def test_init_model_reads_a_jax_bundle(tmp_path):
    jm, bundle, _ = _pair("FFDNet", seed=10)
    jb = jax.tree_util.tree_map(jnp.asarray, bundle)
    jopt = jax_make_optimizer(1e-3, clip_grad=0.05)
    jax_ckpt.save_ckpt(str(tmp_path / "net.ckpt"), jb, 4, jopt.init(jb[0]), 2e-4)
    args = _args(tmp_path, "FFDNet")
    args["paths"]["ckpt"] = str(tmp_path / "net.ckpt")
    model, _, opt_state, epoch, _ = init_model(args, device="cpu")
    assert epoch == 4 and get_lr(opt_state) == pytest.approx(2e-4)
    for ours, theirs in zip(export_jax_params(model), bundle):
        for k, v in theirs.items():
            np.testing.assert_array_equal(ours[k], v)


def test_backend_is_not_injected():
    """A family with no backend field builds without one from the CLIs and
    Denoiser.from_args (the JAX resolve_backend rule)."""
    assert resolve_backend("DnCNN") is None and resolve_backend("FFDNet", "xla") is None
    assert resolve_backend("CDLNet") == "pallas" and resolve_backend("JDD_CDLNet", "xla") == "xla"
    args = {"type": "DnCNN", "model": {"K": 3, "M": 4}}
    assert cli_train.apply_backend("auto", args) == args
    assert cli_train.apply_backend("cuda", args) == args
    d = Denoiser.from_args(args, backend="cuda", device="cpu")
    assert isinstance(d.model, DnCNN) and not d.model.training
    with pytest.raises(NotImplementedError, match="unknown model type"):
        build_model("DnCNN3D", {})


def test_denoiser_serves_on_the_running_statistics(tmp_path):
    """Denoiser on a DnCNN with non-trivial statistics against JAX's apply
    with those statistics (train=False), one image and a batch; FFDNet
    with known sigma, one per image, and blind (its map at 255 x JAX's MAD
    estimate)."""
    jm, bundle, _ = _pair("DnCNN", seed=11)
    jax_ckpt.save_ckpt(str(tmp_path / "net.ckpt"), jax.tree_util.tree_map(jnp.asarray, bundle))
    args = _args(tmp_path, "DnCNN")
    args["paths"]["ckpt"] = str(tmp_path / "net.ckpt")
    d = Denoiser.from_args(args, device="cpu")
    imgs = _images((2, 1, 64, 64), seed=12)
    (want, _), _ = jm.apply(bundle[0], jnp.asarray(imgs), state=bundle[1], train=False)
    np.testing.assert_allclose(d.denoise_image(imgs[0, 0]), np.asarray(want)[0, 0], atol=TOL)
    np.testing.assert_allclose(d.denoise_image_batch(imgs), np.asarray(want), atol=TOL)

    jf, fb, model = _pair("FFDNet", seed=13)
    d = Denoiser(model)
    sig = np.array([15.0, 35.0], np.float32)
    (want, _), _ = jf.apply(fb[0], jnp.asarray(imgs), jnp.asarray(sig), state=fb[1])
    np.testing.assert_allclose(d.denoise_image_batch(imgs, sig), np.asarray(want), atol=TOL)
    s_hat = 255.0 * jax_nle.noise_level(jnp.asarray(imgs), method="MAD")
    (want, _), _ = jf.apply(fb[0], jnp.asarray(imgs), s_hat, state=fb[1])
    np.testing.assert_allclose(d.denoise_image_batch(imgs), np.asarray(want), atol=TOL)
