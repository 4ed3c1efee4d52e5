"""The 2D (image) training loop and entry points of cdlnet_tpu_torch on the
CPU: a 10-step trajectory against a JAX optax loop, make_train_step and
fit(workload="2d"), the port's image loaders against the JAX package's,
and the train CLI (cli.train.main on device="cpu") on a tiny CDLNet.

Inputs and noise come from numpy seeds and go to both packages; the image
directories come from data/synthetic.py."""

import json
import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu.data.images import get_fit_loaders as jax_get_fit_loaders
from cdlnet_tpu.data.synthetic import gen_synthetic_image_dirs as jax_gen_image_dirs
from cdlnet_tpu.models import CDLNet as JaxCDLNet
from cdlnet_tpu.train.losses import mse_loss as jax_mse_loss
from cdlnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from cdlnet_tpu_torch.cli import train as cli_train
from cdlnet_tpu_torch.compat.jax_params import export_jax_params, load_jax_params
from cdlnet_tpu_torch.data.images import get_fit_loaders
from cdlnet_tpu_torch.data.noise import awgn, gen_bayer_mask
from cdlnet_tpu_torch.data.synthetic import gen_natural_image_dirs, gen_synthetic_image_dirs
from cdlnet_tpu_torch.models import CDLNet, CDLNetVideo
from cdlnet_tpu_torch.train.checkpoint import load_ckpt
from cdlnet_tpu_torch.train.fit import fit, make_train_step, train_update
from cdlnet_tpu_torch.train.optim import get_lr, make_optimizer

FAMILIES = {
    "cdlnet": (dict(K=3, M=8, P=7, s=2, C=1, adaptive=True), False),
    "jdd": (dict(K=3, M=8, P=7, s=1, C=3, adaptive=True), True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' on these tiny shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --- (1) a 10-step trajectory on fixed noisy batches against a JAX loop of
# model.apply(xla) + mse_loss + opt.update + project ---

def _images(n, seed, shape=(2, 1, 16, 20)):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(*(np.linspace(-np.pi, np.pi, k, dtype=np.float32)
                           for k in shape[2:]), indexing="ij")
    out = []
    for _ in range(n):
        a, b = rng.uniform(0.5, 3, 2)
        img = 0.5 + 0.25 * np.sin(a * xx + rng.uniform(0, 6)) * np.cos(b * yy)
        out.append(np.broadcast_to(img, shape).astype(np.float32).copy())
    return out


@pytest.mark.parametrize("family", ["cdlnet", "jdd"])
def test_10_step_trajectory_tracks_jax(family, monkeypatch):
    """Each step: the same noisy batch (fixed arrays) to both loops. Held at
    1e-4 relative on the loss and 2e-4 relative on the parameters after
    10 steps: fp32 rounding of ~1e-7 per step compounds through Adam."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    cfg, masked = FAMILIES[family]
    params = jax.tree_util.tree_map(
        np.asarray, JaxCDLNet(**cfg).init(jax.random.PRNGKey(1), init=True))
    params["t"] = np.full(params["t"].shape, 0.01, np.float32)
    rng = np.random.default_rng(7)
    batches = _images(10, seed=8, shape=(2, cfg["C"], 16, 20))
    sigmas = [rng.uniform(20, 30, (2, 1, 1, 1)).astype(np.float32) for _ in batches]
    mask = gen_bayer_mask(torch.from_numpy(batches[0])).numpy() if masked else None
    noisy = [b + rng.standard_normal(b.shape).astype(np.float32) * s / 255
             for b, s in zip(batches, sigmas)]
    if mask is not None:
        noisy = [mask * y for y in noisy]

    jm = JaxCDLNet(**cfg)
    jopt = jax_make_optimizer(2e-3, clip_grad=0.05)
    jmask = None if mask is None else jnp.asarray(mask)

    @jax.jit
    def jstep(p, st, y, sig, clean):
        loss, g = jax.value_and_grad(lambda q: jax_mse_loss(
            jm.apply(q, y, sig, mask=jmask, return_z=False, train=True)[0], clean))(p)
        upd, st = jopt.update(g, st, p)
        return jm.project(jax.tree_util.tree_map(lambda a, u: a + u, p, upd)), st, loss

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jopt.init(jp)
    model = load_jax_params(CDLNet(**cfg, backend="pallas"), params)
    opt = make_optimizer(2e-3, clip_grad=0.05)
    state = opt.init(dict(model.named_parameters()))
    tmask = None if mask is None else torch.from_numpy(mask)
    jl, tl = [], []
    for y, sig, clean in zip(noisy, sigmas, batches):
        jp, jst, loss = jstep(jp, jst, jnp.asarray(y), jnp.asarray(sig), jnp.asarray(clean))
        jl.append(float(loss))
        tl.append(float(train_update(model, opt, state, torch.from_numpy(y),
                                     torch.from_numpy(sig), torch.from_numpy(clean),
                                     mask=tmask)))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert np.mean(tl[-3:]) < np.mean(tl[:3])
    got = export_jax_params(model)
    for k in "ABt":
        assert _rel(got[k], jp[k]) <= 2e-4, k
    np.testing.assert_array_equal(got["g"], np.asarray(jp["g"]))  # unused: zero gradient


@pytest.mark.parametrize("demosaic", [False, True])
def test_2d_train_step_is_train_update_on_its_noise(demosaic):
    """make_train_step(workload="2d") draws per-image sigma in the range,
    AWGN of (N, C, H, W) shape and, with demosaic, the RGGB mask; its step
    is train_update on exactly that observation."""
    cfg = dict(K=2, M=6, P=5, s=2 - demosaic, C=1 + 2 * demosaic, adaptive=True)
    batch = torch.from_numpy(_images(1, seed=9, shape=(2, cfg["C"], 12, 16))[0])
    losses, params = [], []
    for run in ("step", "update"):
        model = CDLNet(**cfg, backend="pallas").init(torch.Generator().manual_seed(0))
        opt = make_optimizer(1e-3, clip_grad=0.05)
        state = opt.init(dict(model.named_parameters()))
        gen = torch.Generator().manual_seed(3)
        if run == "step":
            step, _ = make_train_step(model, opt, workload="2d", noise_std=(20, 30),
                                      demosaic=demosaic)
            losses.append(step(state, batch, gen))
        else:
            noisy, sigma = awgn(batch, (20, 30), gen)
            assert sigma.shape == (2, 1, 1, 1) and ((sigma >= 20) & (sigma <= 30)).all()
            mask = gen_bayer_mask(batch) if demosaic else None
            losses.append(train_update(model, opt, state,
                                       noisy if mask is None else mask * noisy,
                                       sigma, batch, mask=mask))
        params.append(model.A.detach().clone())
    assert torch.equal(losses[0], losses[1])
    assert torch.equal(params[0], params[1])


def test_train_update_zero_fills_only_the_declared_unused_parameters():
    """CDLNet's g, which its forward never reads, gets a zero gradient (it
    stays at its value through Adam, as under jax.grad); a parameter that
    the loss does not reach and the model does not declare makes autograd
    raise instead of training on a silent zero."""
    batch = torch.from_numpy(_images(1, seed=9, shape=(2, 1, 12, 16))[0])
    noisy, sigma = awgn(batch, (20, 30), torch.Generator().manual_seed(3))
    model = CDLNet(K=2, M=6, P=5, s=2, C=1, adaptive=True, t0=0.1, backend="pallas").init(
        torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3, clip_grad=0.05)
    state = opt.init(dict(model.named_parameters()))
    g0, a0 = model.g.detach().clone(), model.A.detach().clone()
    train_update(model, opt, state, noisy, sigma, batch)
    assert torch.equal(model.g, g0) and not torch.equal(model.A, a0)
    assert not state["mu"]["g"].any()
    model.unused_params = ()
    with pytest.raises(RuntimeError, match="not have been used"):
        train_update(model, opt, state, noisy, sigma, batch)


# --- (2) fit(workload="2d"): JAX's log formats, and backtracking on a NaN ---

def _loaders(n=4, C=3, poison_epoch=None):
    imgs = [b[:1] for b in _images(n, seed=11, shape=(2, C, 16, 16))]

    class Train:
        epoch = 0

        def __iter__(self):
            Train.epoch += 1
            for i in range(0, n, 2):
                b = np.concatenate(imgs[i:i + 2])
                yield b + np.nan if Train.epoch == poison_epoch else b

    return {"train": Train(), "val": imgs[:2], "test": imgs[:1]}


def _jdd_model():
    return CDLNet(K=3, M=6, P=5, s=1, C=3, adaptive=True, backend="pallas").init(
        torch.Generator().manual_seed(0))


def test_fit_2d_demosaic_writes_jax_formats(tmp_path):
    model = _jdd_model()
    opt = make_optimizer(1e-3, clip_grad=0.05)
    state = opt.init(dict(model.named_parameters()))
    state, history = fit(model, opt, state, _loaders(), save_dir=str(tmp_path), epochs=3,
                         noise_std=(1, 20), val_freq=2, save_freq=1, verbose=False,
                         demosaic=True, workload="2d", sched={"step_size": 2, "gamma": 0.5})
    assert [(e, ph) for e, ph, _ in history] == [
        (1, "train"), (2, "train"), (2, "val"), (3, "train"), (3, "test")]
    for phase in ("train", "val", "test"):
        text = (tmp_path / f"{phase}.txt").read_text()
        assert re.fullmatch(r"(-?\d+\.\d{3}, )+", text), text
        assert text == "".join(f"{p:.3f}, " for _, ph, p in history if ph == phase)
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["epoch"], r["phase"]) for r in rows] == [(e, ph) for e, ph, _ in history]
    assert get_lr(state) == pytest.approx(0.5e-3)  # StepLR at epoch 2
    reloaded = CDLNet(K=3, M=6, P=5, s=1, C=3, adaptive=True)
    _, _, epoch, _ = load_ckpt(str(tmp_path / "net.ckpt.npz"), reloaded)
    assert epoch == 3 and torch.equal(reloaded.A, model.A)
    assert (model.t >= 0).all()
    assert (model.A.detach().flatten(3).norm(dim=3) <= 1 + 1e-5).all()


def test_fit_2d_backtracks_on_nan(tmp_path):
    model = _jdd_model()
    opt = make_optimizer(1e-3, clip_grad=1.0)
    state = opt.init(dict(model.named_parameters()))
    state, _ = fit(model, opt, state, _loaders(poison_epoch=3), save_dir=str(tmp_path),
                   epochs=4, noise_std=25, val_freq=100, save_freq=1, verbose=False,
                   backtrack_thresh=1, demosaic=True, workload="2d")
    assert (tmp_path / "backtrack.txt").read_text() == "3  "
    assert get_lr(state) == pytest.approx(1e-3 * 0.8)
    assert all(torch.isfinite(p).all() for p in model.parameters())


# --- (3) the port's image loaders against the JAX package's ---

@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("images"))
    gen_synthetic_image_dirs(root, n_images=6, size=40, seed=0)
    return root


def test_synthetic_image_dirs_match_jax(image_dirs, tmp_path):
    jax_gen_image_dirs(str(tmp_path), n_images=6, size=40, seed=0)
    for split in ("train", "val", "test"):
        names = sorted(os.listdir(os.path.join(image_dirs, split)))
        assert names == sorted(os.listdir(tmp_path / split)) and len(names) == 6
        for name in names:
            with open(os.path.join(image_dirs, split, name), "rb") as a, \
                    open(tmp_path / split / name, "rb") as b:
                assert a.read() == b.read()


@pytest.mark.parametrize("load_color", [False, True])
def test_image_loaders_yield_the_jax_batches(image_dirs, load_color):
    """Two epochs of shuffled random crops with flips, then the full-size
    val and test images: the same arrays from both packages for a seed."""
    kw = dict(trn_path_list=[os.path.join(image_dirs, "train")],
              val_path_list=[os.path.join(image_dirs, "val")],
              tst_path_list=[os.path.join(image_dirs, "test")],
              crop_size=16, batch_size=[4, 1, 1], load_color=load_color, seed=3)
    ours, theirs = get_fit_loaders(**kw), jax_get_fit_loaders(**kw)
    for phase, epochs in (("train", 2), ("val", 1), ("test", 1)):
        assert len(ours[phase]) == len(theirs[phase])
        for _ in range(epochs):
            got, want = list(ours[phase]), list(theirs[phase])
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert a.dtype == np.float32 and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    assert got[0].shape == (1, 3 if load_color else 1, 40, 40)


def test_natural_image_dirs_hold_the_splits(tmp_path):
    gen_natural_image_dirs(str(tmp_path), n_train=3, n_test=2, size=32, seed=0)
    counts = {split: len(os.listdir(tmp_path / split)) for split in ("train", "val", "test")}
    assert counts == {"train": 3, "val": 8, "test": 2}


# --- (4) the train CLI ---

def _cli_args(image_dirs, save, mtype="CDLNet", **model):
    return {"type": mtype,
            "model": dict(dict(K=2, M=6, P=5, s=2, C=1, adaptive=True, init=True), **model),
            "paths": {"save": save, "ckpt": None},
            "train": {"opt": {"lr": 1e-3},
                      "fit": {"epochs": 2, "noise_std": [15, 35], "val_freq": 1,
                              "save_freq": 1, "backtrack_thresh": 1, "clip_grad": 0.05},
                      "loaders": {"trn_path_list": [os.path.join(image_dirs, "train")],
                                  "val_path_list": [os.path.join(image_dirs, "val")],
                                  "tst_path_list": [os.path.join(image_dirs, "test")],
                                  "crop_size": 16, "batch_size": [3, 1, 1]},
                      "sched": {"step_size": 1, "gamma": 0.5}}}


def test_cli_main_trains_a_tiny_cdlnet(image_dirs, tmp_path):
    args = _cli_args(image_dirs, str(tmp_path), backend="pallas")
    state, history = cli_train.main(args, device="cpu")
    assert [(e, ph) for e, ph, _ in history] == [
        (1, "train"), (1, "val"), (2, "train"), (2, "val"), (2, "test")]
    for phase in ("train", "val", "test"):
        text = (tmp_path / f"{phase}.txt").read_text()
        assert re.fullmatch(r"(-?\d+\.\d{3}, )+", text), text
    assert (tmp_path / "net.ckpt.npz").exists() and (tmp_path / "0.ckpt.npz").exists()
    saved = json.loads((tmp_path / "args.json").read_text())
    assert saved["paths"]["ckpt"] == os.path.join(str(tmp_path), "net.ckpt.npz")
    assert saved["model"] == args["model"]
    assert get_lr(state) == pytest.approx(1e-3 * 0.5**2)
    model = CDLNet(K=2, M=6, P=5, s=2, C=1, adaptive=True)
    _, _, epoch, lr = load_ckpt(str(tmp_path / "net.ckpt.npz"), model)
    assert epoch == 2 and lr == pytest.approx(get_lr(state))
    # resuming from the saved args continues at epoch 3
    saved["train"]["fit"]["epochs"] = 1
    _, resumed = cli_train.main(saved, device="cpu")
    assert [e for e, _, _ in resumed] == [3, 3]


@pytest.mark.parametrize("mtype,model,loaders", [
    ("JDD_CDLNet", dict(C=3, s=1), {"load_color": True}),
    ("GDLNet", dict(order=1), {}),
])
def test_cli_main_trains_jdd_and_gdlnet(image_dirs, tmp_path, mtype, model, loaders):
    args = _cli_args(image_dirs, str(tmp_path), mtype, **model)
    args["train"]["loaders"].update(loaders)
    args["train"]["fit"].update(epochs=1, demosaic=mtype == "JDD_CDLNet")
    _, history = cli_train.main(args, device="cpu")
    assert [ph for _, ph, _ in history] == ["train", "val", "test"]
    assert all(np.isfinite(p) for _, _, p in history)
    assert (tmp_path / "net.ckpt.npz").exists()


@pytest.mark.parametrize("mtype,loaders,model", [
    pytest.param("DnCNN", {}, dict(K=3, M=6), id="DnCNN-loaders0"),
    pytest.param("FFDNet", {}, dict(C=1, K=3, M=6), id="FFDNet-loaders1"),
])
def test_cli_unported_families_raise(image_dirs, tmp_path, mtype, loaders, model):
    """DnCNN and FFDNet (the test's name is from before they were ported)
    train one epoch from image directories, BatchNorm statistics included
    (tests/test_torch_cli_baselines.py holds them to JAX); a type the CLI
    has no workload for raises. The fastMRI (PDFS) and CSR branches train
    (tests/test_torch_csr_train.py), and so does CDLNetVideo with residual
    blocks (tests/test_torch_residual.py)."""
    args = _cli_args(image_dirs, str(tmp_path), mtype)
    args["model"] = model
    args["train"]["loaders"].update(loaders)
    args["train"]["fit"]["epochs"] = 1
    _, history = cli_train.main(args, device="cpu")
    assert [ph for _, ph, _ in history] == ["train", "val", "test"]
    assert all(np.isfinite(p) for _, _, p in history)
    keys = np.load(tmp_path / "net.ckpt.npz").files
    assert "p::[0]['w_mid']" in keys and "p::[1]['bn_mean']" in keys
    with pytest.raises(NotImplementedError, match="no workload"):
        cli_train.main(dict(args, type="UNet"), device="cpu")


def test_unported_workload_raises():
    """workload "mri" (fastMRI volumes into CDLNetVideo; the test's name is
    from before it was ported) is the volumetric step: the same noise and
    loss as workload "3d" from the same generator state."""
    model = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=1, C=1, adaptive=True)
    model.init(torch.Generator().manual_seed(0))
    batch = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(2, 1, 3, 8, 8)).astype(np.float32))
    losses = {}
    for workload in ("3d", "mri"):
        _, eval_step = make_train_step(model, make_optimizer(1e-3), workload=workload,
                                       noise_std=(20, 30))
        losses[workload] = eval_step(batch, torch.Generator().manual_seed(4))
    assert torch.equal(losses["mri"], losses["3d"]) and float(losses["mri"]) > 0


@pytest.mark.parametrize("choice,pinned,want", [
    ("auto", None, "pallas"), ("auto", "xla", "xla"), ("xla", "pallas", "xla"),
    ("cuda", None, "cuda"),
])
def test_cli_backend_flag(choice, pinned, want):
    args = {"type": "CDLNet", "model": {"K": 2} if pinned is None else {"K": 2, "backend": pinned}}
    got = cli_train.apply_backend(choice, args)
    assert got["model"]["backend"] == want
    assert args["model"].get("backend") == pinned  # the input is not changed


def test_cli_main_defaults_to_the_card(image_dirs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli_train.main(_cli_args(image_dirs, str(tmp_path)))
