"""cdlnet_tpu_torch's MC-SURE and combined VGG16/SSIM losses against the
JAX package's (cdlnet_tpu/train/losses.py), MC-SURE and combmse training
through make_train_step, fit and the train CLI, and the BatchNorm running
statistics under MC-SURE's two passes."""

import functools
import importlib
import json
import os
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu.models import CDLNet as JaxCDLNet
from cdlnet_tpu.models import CDLNetVideo as JaxCDLNetVideo
from cdlnet_tpu.models import DnCNN as JaxDnCNN
from cdlnet_tpu.train import losses as jax_losses
from cdlnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from cdlnet_tpu_torch.cli import train as cli_train
from cdlnet_tpu_torch.compat.jax_params import export_jax_params, load_jax_params
from cdlnet_tpu_torch.data.synthetic import gen_natural_image_dirs, gen_synthetic_video_dirs
from cdlnet_tpu_torch.models import CDLNet, CDLNetVideo, DnCNN
from cdlnet_tpu_torch.train import fit as fit_mod
from cdlnet_tpu_torch.train import losses
from cdlnet_tpu_torch.train.fit import fit, make_train_step
from cdlnet_tpu_torch.train.optim import make_optimizer

jax_fit = importlib.import_module("cdlnet_tpu.train.fit")

TOL_LOSS, TOL_GRAD = 1e-5, 1e-4
FAMILIES = {
    "cdlnet": (JaxCDLNet, CDLNet, dict(K=3, M=8, P=7, s=2, C=1, adaptive=True), (2, 1, 20, 18)),
    "video": (JaxCDLNetVideo, CDLNetVideo,
              dict(K=2, M=6, P=(5, 5, 3), s=2, C=1, adaptive=True, depth=4), (2, 1, 4, 12, 14)),
}
# the convs of torchvision's vgg16().features through relu3_3: index, out, in
VGG_CONVS = [(0, 64, 3), (2, 64, 64), (5, 128, 64), (7, 128, 128), (10, 256, 128),
             (12, 256, 256), (14, 256, 256)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _family_params(jax_cls, cfg, seed=0):
    params = jax.tree_util.tree_map(
        np.asarray, jax_cls(**cfg).init(jax.random.PRNGKey(seed), init=True))
    params["t"] = np.abs(np.random.default_rng(seed).standard_normal(
        params["t"].shape)).astype(np.float32) * 0.05
    return params


def _mcsure_case(family):
    """(params, y, sigma, b) of one family's MC-SURE case."""
    jax_cls, _, cfg, shape = FAMILIES[family]
    rng = np.random.default_rng(3)
    y = (rng.uniform(size=shape) + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    sigma = np.array([20.0, 30.0], np.float32).reshape((2,) + (1,) * (len(shape) - 1))
    b = np.array(jax.random.normal(jax.random.PRNGKey(7), shape, jnp.float32))
    return _family_params(jax_cls, cfg), y, sigma, b


@functools.cache
def _jax_mcsure(family):
    """JAX's MC-SURE loss and gradients (jax.value_and_grad of its
    mcsure_loss on its plain reference, jitted) for _mcsure_case(family):
    its probe is the draw of the key it is given."""
    jax_cls, _, cfg, _ = FAMILIES[family]
    params, y, sigma, _ = _mcsure_case(family)
    jm = jax_cls(**cfg)
    apply_j = lambda p, v: jm.apply(p, v, jnp.asarray(sigma), return_z=False, train=True)[0]
    loss = lambda p: jax_losses.mcsure_loss(apply_j, p, jnp.asarray(y), jnp.asarray(sigma),
                                            jax.random.PRNGKey(7))
    return jax.jit(jax.value_and_grad(loss))(jax.tree_util.tree_map(jnp.asarray, params))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_mcsure_loss_and_gradients_match_jax(family, backend):
    """The same obsrv, per-sample sigma and probe b (JAX's draw from the
    key its mcsure_loss takes, passed to the port): the loss and every
    parameter's gradient, the port through its reverse loop ("pallas") and
    through torch autograd ("xla")."""
    _, cls, cfg, _ = FAMILIES[family]
    params, y, sigma, b = _mcsure_case(family)
    v_ref, g_ref = _jax_mcsure(family)
    model = load_jax_params(cls(**cfg, backend=backend), params)
    sig_t = torch.from_numpy(sigma)
    loss = losses.mcsure_loss(lambda v: model(v, sig_t)[0], torch.from_numpy(y), sig_t,
                              b=torch.from_numpy(b))
    named = dict(model.named_parameters())
    names = sorted(n for n in named if n != "g")
    grads = torch.autograd.grad(loss, [named[n] for n in names])
    np.testing.assert_allclose(float(loss.detach()), float(v_ref), rtol=TOL_LOSS)
    for n, g in zip(names, grads):
        assert _rel(g, g_ref[n]) <= TOL_GRAD, n


def test_mcsure_draws_its_probe_from_the_generator():
    y = torch.rand(2, 1, 8, 8)
    f = lambda v: 0.5 * v + 0.1 * v**2
    got = losses.mcsure_loss(f, y, 25.0, generator=torch.Generator().manual_seed(4))
    b = torch.randn(y.shape, generator=torch.Generator().manual_seed(4))
    assert torch.equal(got, losses.mcsure_loss(f, y, 25.0, b=b))
    # f(y) = y: the divergence of the identity is 1 a pixel, the residual 0
    ident = losses.mcsure_loss(lambda v: v, y, 25.0, b=b)
    assert abs(float(ident) - 2 * (25 / 255) ** 2 * float((b * b).mean())) < 1e-6


@pytest.fixture
def vgg_weights(tmp_path, monkeypatch):
    """Seeded weights of VGG16's shapes (torchvision's keys) at a temporary
    path that both packages read, their caches cleared around the test."""
    g = torch.Generator().manual_seed(0)
    sd = {}
    for i, co, ci in VGG_CONVS:
        sd[f"features.{i}.weight"] = 0.1 * torch.randn(co, ci, 3, 3, generator=g)
        sd[f"features.{i}.bias"] = 0.1 * torch.randn(co, generator=g)
    path = str(tmp_path / "vgg16-397923af.pth")
    torch.save(sd, path)
    for mod in (losses, jax_losses):
        monkeypatch.setattr(mod, "_VGG_WEIGHT_PATHS", [path])
        mod._load_vgg16_weights.cache_clear()
    yield sd
    for mod in (losses, jax_losses):
        mod._load_vgg16_weights.cache_clear()


@pytest.fixture
def no_vgg_weights(tmp_path, monkeypatch):
    for mod in (losses, jax_losses):
        monkeypatch.setattr(mod, "_VGG_WEIGHT_PATHS", [str(tmp_path / "none.pth")])
        monkeypatch.setattr(mod, "_warned_no_vgg", True)  # the warning is tested alone
        mod._load_vgg16_weights.cache_clear()
    yield
    for mod in (losses, jax_losses):
        mod._load_vgg16_weights.cache_clear()


def test_vgg16_features_match_jax(vgg_weights):
    x = np.random.default_rng(0).uniform(size=(2, 3, 20, 16)).astype(np.float32)
    got = losses.vgg16_features(torch.from_numpy(x))
    want = np.asarray(jax_losses.vgg16_features(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 256, 5, 4)
    assert _rel(got, want) <= TOL_LOSS


def test_vgg16_features_without_weights(no_vgg_weights):
    x = torch.rand(1, 3, 8, 8)
    assert losses.vgg16_features(x) is None
    assert jax_losses.vgg16_features(jnp.asarray(x.numpy())) is None


def _video_pair(seed, shape=(2, 1, 3, 16, 16), C=None):
    rng = np.random.default_rng(seed)
    if C is not None:
        shape = (shape[0], C) + shape[2:]
    tgt = rng.uniform(size=shape).astype(np.float32)
    out = (tgt + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return out, tgt


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("weights", ["vgg", "no_vgg"])
def test_combined_loss_and_gradient_match_jax(weights, channels, request):
    """The loss and its gradient with respect to the output, with seeded
    VGG weights (the perceptual term on) and without them (dropped)."""
    request.getfixturevalue("vgg_weights" if weights == "vgg" else "no_vgg_weights")
    out, tgt = _video_pair(1, C=channels)
    v_ref, g_ref = jax.jit(jax.value_and_grad(jax_losses.combined_loss))(
        jnp.asarray(out), jnp.asarray(tgt))
    o = torch.from_numpy(out).requires_grad_()
    loss = losses.combined_loss(o, torch.from_numpy(tgt))
    (g,) = torch.autograd.grad(loss, [o])
    np.testing.assert_allclose(float(loss.detach()), float(v_ref), rtol=TOL_LOSS)
    assert _rel(g, g_ref) <= TOL_GRAD


def test_combined_loss_per_frame_data_range(no_vgg_weights):
    """The SSIM term uses the reference's per-frame data_range (loss.py:52)
    over each frame's whole (N, 3, H, W) slab: frames with very different
    dynamic ranges reproduce an explicit per-frame loop (the case of
    tests/test_losses.py)."""
    rng = np.random.default_rng(0)
    N, C, D, H, W = 2, 1, 3, 32, 32
    scales = np.array([1.0, 0.3, 2.5], np.float32)
    tgt = rng.random((N, C, D, H, W)).astype(np.float32) * scales[None, None, :, None, None]
    out = tgt + 0.1 * rng.standard_normal(tgt.shape).astype(np.float32)
    o, t = torch.from_numpy(out), torch.from_numpy(tgt)
    got = float(losses.combined_loss(o, t, alpha=1.0, beta=0.01, gamma=0.1))
    expect = float(losses.mse_loss(o, t))
    sterm = 0.0
    for d in range(D):
        ofr = o[:, :, d].repeat(1, 3, 1, 1)
        tfr = t[:, :, d].repeat(1, 3, 1, 1)
        dr = float(ofr.max() - ofr.min())
        sterm += 1.0 - float(losses.ssim(ofr, tfr, data_range=dr))
    expect += 0.1 * sterm / D
    assert got == pytest.approx(expect, abs=1e-5)


def test_combined_loss_warns_once_without_weights(tmp_path, monkeypatch):
    monkeypatch.setattr(losses, "_VGG_WEIGHT_PATHS", [str(tmp_path / "none.pth")])
    monkeypatch.setattr(losses, "_warned_no_vgg", False)
    losses._load_vgg16_weights.cache_clear()
    out, tgt = (torch.from_numpy(a) for a in _video_pair(2))
    try:
        with pytest.warns(UserWarning, match="VGG16 pretrained weights not found"):
            first = losses.combined_loss(out, tgt)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            second = losses.combined_loss(out, tgt)
    finally:
        losses._load_vgg16_weights.cache_clear()
    assert torch.isfinite(first) and torch.equal(first, second)


def _fixed_noise(noisy, sigma):
    """awgn for both packages that returns the given noisy batch."""
    def jax_awgn(key, x, nstd):
        return jnp.asarray(noisy), jnp.asarray(sigma)

    def torch_awgn(x, nstd, generator=None):
        return torch.from_numpy(noisy), torch.from_numpy(sigma)

    return jax_awgn, torch_awgn


def test_mcsure_step_keeps_the_unperturbed_statistics(monkeypatch):
    """One MC-SURE step of a DnCNN: the running statistics are those of the
    unperturbed pass alone, as JAX's new_state; the loss is MC-SURE with
    each pass normalised by its own batch's statistics."""
    jm = JaxDnCNN(K=4, M=6)
    params, state = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    model = load_jax_params(DnCNN(K=4, M=6), (params, state))
    rng = np.random.default_rng(4)
    clean = rng.uniform(size=(3, 1, 12, 12)).astype(np.float32)
    sigma = np.array([20.0, 25.0, 30.0], np.float32).reshape(3, 1, 1, 1)
    noisy = (clean + sigma / 255 * rng.standard_normal(clean.shape)).astype(np.float32)
    jax_awgn, torch_awgn = _fixed_noise(noisy, sigma)
    monkeypatch.setattr(jax_fit, "awgn", jax_awgn)
    monkeypatch.setattr(fit_mod, "awgn", torch_awgn)

    jopt = jax_make_optimizer(1e-3, clip_grad=0.05)
    jstep, _ = jax_fit.make_train_step(jm, jopt, workload="2d", noise_std=(20, 30),
                                       stateful=True, mcsure=True)
    jparams, jstate = jax.tree_util.tree_map(jnp.asarray, (params, state))
    _, jstate, _, _ = jstep(jparams, jstate, jopt.init(jparams), jnp.asarray(clean),
                            jax.random.PRNGKey(0))

    # the references on copies: one unperturbed train-mode pass, and the
    # MC-SURE loss on the step's probe (the first draw of its generator,
    # the noise being fixed)
    alone = load_jax_params(DnCNN(K=4, M=6), (params, state)).train()
    y = torch.from_numpy(noisy)
    with torch.no_grad():
        alone(y)
    b = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
    ref = load_jax_params(DnCNN(K=4, M=6), (params, state)).train()
    with torch.no_grad():
        want_loss = losses.mcsure_loss(lambda v: ref(v)[0], y, torch.from_numpy(sigma), b=b)

    opt = make_optimizer(1e-3, clip_grad=0.05)
    step, _ = make_train_step(model, opt, workload="2d", noise_std=(20, 30), mcsure=True)
    loss = step(opt.init(dict(model.named_parameters())), torch.from_numpy(clean),
                torch.Generator().manual_seed(5))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    for k in ("bn_mean", "bn_var"):
        assert torch.equal(getattr(model, k), getattr(alone, k)), k
        np.testing.assert_allclose(getattr(model, k).numpy(), np.asarray(jstate[k]),
                                   atol=1e-5, err_msg=k)
    assert not np.allclose(export_jax_params(model)[1]["bn_mean"], state["bn_mean"])


def test_unported_and_invalid_step_options_raise():
    model = CDLNet(K=2, M=4, P=3)
    opt = make_optimizer(1e-3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_step(model, opt, workload="2d", mesh={"data": -1})
    with pytest.raises(ValueError, match="combined loss"):
        make_train_step(model, opt, workload="2d", loss_type="combmse")
    with pytest.raises(ValueError, match="loss_type"):
        make_train_step(model, opt, workload="2d", loss_type="l1")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fit(model, opt, opt.init(dict(model.named_parameters())), {}, save_dir="unused",
            device_scan=True)


def _losses(history):
    return [10 ** (-p / 10) for _, ph, p in history if ph == "train"]


def test_fit_trains_with_mcsure_and_combmse(tmp_path, no_vgg_weights):
    """Two epochs each: MC-SURE on 2D images, the combined loss on clips
    (no VGG weights: the perceptual term dropped), finite losses; the
    eval phases stay mse."""
    rng = np.random.default_rng(6)
    imgs = rng.uniform(size=(2, 1, 16, 16)).astype(np.float32)
    m2 = CDLNet(K=2, M=4, P=5, s=2, adaptive=True, backend="pallas").init(
        torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3, clip_grad=0.05)
    st = opt.init(dict(m2.named_parameters()))
    _, hist = fit(m2, opt, st, {"train": [imgs, imgs], "val": [imgs], "test": [imgs]},
                  save_dir=str(tmp_path / "sure"), epochs=2, noise_std=(20, 30),
                  mcsure=True, workload="2d", verbose=False)
    assert len(_losses(hist)) == 2 and all(np.isfinite(p) for _, _, p in hist)

    clips = rng.uniform(size=(1, 1, 4, 16, 16)).astype(np.float32)
    m3 = CDLNetVideo(K=2, M=4, P=(5, 5, 3), s=2, adaptive=True, depth=4,
                     backend="pallas").init(torch.Generator().manual_seed(0))
    st = opt.init(dict(m3.named_parameters()))
    _, hist = fit(m3, opt, st, {"train": [clips], "val": [clips], "test": [clips]},
                  save_dir=str(tmp_path / "comb"), epochs=2, noise_std=(20, 30),
                  loss_type="combmse", verbose=False)
    assert len(_losses(hist)) == 2 and all(np.isfinite(p) for _, _, p in hist)


def test_train_cli_with_mcsure_and_combmse(tmp_path, no_vgg_weights):
    """JAX-schema args.json with "mcsure": true (2D image directories) and
    "combmse": true (video frame directories) through cli.train.main."""
    images = gen_natural_image_dirs(str(tmp_path / "img"), n_train=2, n_test=1, size=32,
                                    seed=0)
    videos = gen_synthetic_video_dirs(str(tmp_path / "vid"), n_videos=1, depth=4, size=16)
    for mtype, model, data, fit_key, loaders in (
        ("CDLNet", dict(K=2, M=4, P=5, s=2, C=1), images, "mcsure", {"crop_size": 16}),
        ("CDLNetVideo", dict(K=2, M=4, P=[5, 5, 3], s=2, C=1, depth=4), videos, "combmse",
         {"crop_size": 16, "depth": 4}),
    ):
        save = str(tmp_path / fit_key)
        args = {"type": mtype,
                "model": dict(model, adaptive=True, init=True, backend="pallas"),
                "paths": {"save": save, "ckpt": None},
                "train": {"opt": {"lr": 1e-3},
                          "fit": {"epochs": 1, "noise_std": [15, 35], "val_freq": 1,
                                  "save_freq": 1, "clip_grad": 0.05, fit_key: True,
                                  "verbose": False},
                          "loaders": dict(loaders, batch_size=[2, 1, 1], **{
                              f"{k}_path_list": [os.path.join(data, split)]
                              for k, split in (("trn", "train"), ("val", "val"),
                                               ("tst", "test"))})}}
        _, history = cli_train.main(args, device="cpu")
        assert [ph for _, ph, _ in history] == ["train", "val", "test"], fit_key
        assert all(np.isfinite(p) for _, _, p in history), fit_key
        with open(os.path.join(save, "args.json")) as f:
            assert json.load(f)["train"]["fit"][fit_key] is True
