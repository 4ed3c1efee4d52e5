"""DnCNN and FFDNet through the port's CLIs on the CPU: the train CLI on
image directories and on fastMRI volumes (the PDFS route), cli.analyze
against the JAX CLI's txt, and cli.analyzemri against the JAX package's
apply(..., state=, train=False) frame by frame (JAX's own MRI CLI cannot
run these families).

The CLIs draw their noise from different generators, so the comparisons
feed both packages the same noise: each awgn is replaced by one that adds
seeded numpy noise."""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu.cli import analyze as jax_analyze
from cdlnet_tpu.models import DnCNN as JaxDnCNN
from cdlnet_tpu.models import FFDNet as JaxFFDNet
from cdlnet_tpu.train import checkpoint as jax_ckpt
from cdlnet_tpu.train.losses import ssim as jax_ssim
from cdlnet_tpu_torch.cli import analyze, analyzemri
from cdlnet_tpu_torch.cli import train as cli_train
from cdlnet_tpu_torch.data.fastmri import get_fastmri_data_loader
from cdlnet_tpu_torch.data.images import get_data_loader
from cdlnet_tpu_torch.data.synthetic import gen_synthetic_image_dirs, gen_synthetic_mri_dirs
from cdlnet_tpu_torch.models import DnCNN, FFDNet
from cdlnet_tpu_torch.train.checkpoint import load_ckpt
from cdlnet_tpu_torch.utils import psnr

CFG = {"DnCNN": (JaxDnCNN, DnCNN, dict(K=4, M=8)),
       "FFDNet": (JaxFFDNet, FFDNet, dict(C=1, K=4, M=8))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    return gen_synthetic_image_dirs(str(tmp_path_factory.mktemp("imgs")), n_images=3,
                                    size=32)


@pytest.fixture(scope="module")
def mri_dirs(tmp_path_factory):
    return gen_synthetic_mri_dirs(str(tmp_path_factory.mktemp("mri")), n_volumes=2,
                                  slices=3, size=32)


def _numpy_noise(shape, sigma):
    rng = np.random.default_rng(int(sigma) * 1000 + int(np.prod(shape)) % 997)
    return (float(sigma) / 255.0 * rng.standard_normal(shape)).astype(np.float32)


def _torch_awgn(x, sigma, generator=None):
    noise = torch.from_numpy(_numpy_noise(tuple(x.shape), sigma)).to(x.device)
    return x + noise, torch.as_tensor(sigma, dtype=x.dtype, device=x.device)


def _jax_awgn(key, x, sigma):
    return x + jnp.asarray(_numpy_noise(x.shape, sigma)), jnp.asarray(sigma, jnp.float32)


def _bundle(family, seed):
    """Seeded JAX (params, state) with non-trivial BatchNorm statistics."""
    jax_cls, _, cfg = CFG[family]
    jm = jax_cls(**cfg)
    params, state = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    state = {"bn_mean": rng.uniform(-0.1, 0.1, state["bn_mean"].shape).astype(np.float32),
             "bn_var": rng.uniform(0.5, 1.5, state["bn_var"].shape).astype(np.float32)}
    return jm, (params, state)


def _train_args(loaders, save, family):
    return {"type": family, "model": dict(CFG[family][2]),
            "paths": {"save": save, "ckpt": None},
            "train": {"opt": {"lr": 1e-3},
                      "fit": {"epochs": 2, "noise_std": [15, 35], "save_freq": 1,
                              "backtrack_thresh": 1, "clip_grad": 0.05},
                      "loaders": loaders, "sched": {"step_size": 1, "gamma": 0.5}}}


@pytest.mark.parametrize("family", list(CFG))
def test_train_cli_trains_the_baselines(image_dirs, tmp_path, family):
    """Two epochs from image directories: the phases, the BatchNorm
    statistics trained and checkpointed in a bundle JAX's load_ckpt reads,
    and a resume from the saved args.json at epoch 3."""
    loaders = {f"{k}_path_list": [os.path.join(image_dirs, d)]
               for k, d in (("trn", "train"), ("val", "val"), ("tst", "test"))}
    loaders.update(crop_size=16, batch_size=[3, 1, 1])
    args = _train_args(loaders, str(tmp_path), family)
    _, history = cli_train.main(args, device="cpu")
    assert [(e, ph) for e, ph, _ in history] == [
        (1, "train"), (1, "val"), (2, "train"), (2, "val"), (2, "test")]
    assert all(np.isfinite(p) for _, _, p in history)
    model = CFG[family][1](**CFG[family][2])
    _, _, epoch, _ = load_ckpt(str(tmp_path / "net.ckpt.npz"), model)
    assert epoch == 2 and not torch.equal(model.bn_var, torch.ones_like(model.bn_var))
    jm, tmpl = _bundle(family, 0)
    (jp, js), _, jepoch, _ = jax_ckpt.load_ckpt(str(tmp_path / "net.ckpt.npz"),
                                               jax.tree_util.tree_map(jnp.asarray, tmpl))
    assert jepoch == 2
    np.testing.assert_array_equal(np.asarray(js["bn_var"]), model.bn_var.numpy())
    np.testing.assert_array_equal(np.asarray(jp["w_mid"]), model.w_mid.detach().numpy())
    saved = json.loads((tmp_path / "args.json").read_text())
    saved["train"]["fit"]["epochs"] = 1
    _, resumed = cli_train.main(saved, device="cpu")
    assert [e for e, _, _ in resumed] == [3, 3]


def test_train_cli_takes_fastmri_slices(mri_dirs, tmp_path):
    """The PDFS route: DnCNN on fastMRI volumes, their slices in the batch."""
    loaders = {f"{k}_path_list": [os.path.join(mri_dirs, d)]
               for k, d in (("trn", "train"), ("val", "val"), ("tst", "test"))}
    loaders.update(PDFS=False, crop_size=16, depth=3, batch_size=[1, 1, 1])
    args = _train_args(loaders, str(tmp_path), "DnCNN")
    args["train"]["fit"]["epochs"] = 1
    assert cli_train.make_loaders(args)[1] == "2d"
    _, history = cli_train.main(args, device="cpu")
    assert [ph for _, ph, _ in history] == ["train", "val", "test"]
    assert all(np.isfinite(p) for _, _, p in history)


def _eval_args(tmp_path, family, seed):
    jm, bundle = _bundle(family, seed)
    path = str(tmp_path / f"{family}.ckpt")
    jax_ckpt.save_ckpt(path, jax.tree_util.tree_map(jnp.asarray, bundle))
    args = {"type": family, "model": dict(CFG[family][2]), "paths": {"ckpt": path},
            "train": {"fit": {"noise_std": 25}, "loaders": {"depth": 3}}}
    return jm, bundle, args


def test_analyze_dncnn_writes_the_jax_clis_txt(image_dirs, tmp_path, monkeypatch):
    """Both CLIs evaluate a DnCNN bundle with non-trivial statistics on the
    same images and noise: the same txt bytes. --dictionary raises in both."""
    import cdlnet_tpu.data.noise as jax_noise

    monkeypatch.setattr(jax_noise, "awgn", _jax_awgn)
    monkeypatch.setattr(analyze, "awgn", _torch_awgn)
    _, _, args = _eval_args(tmp_path, "DnCNN", 1)
    argv = ["args.json", "--test", os.path.join(image_dirs, "test"), "--noise_level",
            "15", "25"]
    saves = {p: str(tmp_path / p) for p in ("jax", "torch")}
    jax_analyze.main(jax_analyze.build_argparser().parse_args(argv),
                     dict(args, paths=dict(args["paths"], save=saves["jax"])))
    analyze.main(analyze.build_argparser().parse_args(argv),
                 dict(args, paths=dict(args["paths"], save=saves["torch"])), device="cpu")
    txt = [open(os.path.join(s, "test_test_None.txt"), "rb").read() for s in saves.values()]
    assert txt[0] == txt[1] and len(txt[1].decode().splitlines()) == 2
    for main, parse, kw in ((jax_analyze.main, jax_analyze.build_argparser, {}),
                            (analyze.main, analyze.build_argparser, {"device": "cpu"})):
        with pytest.raises(NotImplementedError):
            main(parse().parse_args(["args.json", "--dictionary"]),
                 dict(args, paths=dict(args["paths"], save=str(tmp_path / "d"))), **kw)


def test_analyze_ffdnet_takes_sigma_into_its_map(image_dirs, tmp_path, monkeypatch):
    """FFDNet's eval line against JAX's apply with the known sigma on the
    same noise (the JAX CLI gives FFDNet a zero map)."""
    monkeypatch.setattr(analyze, "awgn", _torch_awgn)
    jm, bundle, args = _eval_args(tmp_path, "FFDNet", 2)
    args["paths"]["save"] = str(tmp_path)
    test_dir = os.path.join(image_dirs, "test")
    analyze.main(analyze.build_argparser().parse_args(
        ["args.json", "--test", test_dir, "--noise_level", "30"]), args, device="cpu")
    total = 0.0
    for x in get_data_loader([test_dir], test=True):
        y = x + _numpy_noise(x.shape, 30)
        (xhat, _), _ = jm.apply(bundle[0], jnp.asarray(y), 30.0, state=bundle[1])
        total += psnr(x, np.asarray(xhat))
    want = f"30, {total / 3:.3f}\n"
    assert (tmp_path / "test_test_None.txt").read_text() == want


def test_analyzemri_dncnn_matches_jax_apply_per_frame(mri_dirs, tmp_path, monkeypatch):
    """The fastMRI CLI runs DnCNN on each volume's slices in eval mode: its
    line equals the PSNR and SSIM of JAX's apply(state=, train=False) on
    the same noisy frames, to the printed digits."""
    monkeypatch.setattr(analyzemri, "awgn3d", _torch_awgn)
    jm, bundle, args = _eval_args(tmp_path, "DnCNN", 3)
    args["paths"]["save"] = str(tmp_path)
    test_dir = os.path.join(mri_dirs, "test")
    analyzemri.main(analyze.build_argparser().parse_args(
        ["args.json", "--test", test_dir, "--noise_level", "20"]), args, device="cpu")
    p_tot, s_tot, frames = 0.0, 0.0, 0
    for x in get_fastmri_data_loader([test_dir], depth=3, PDFS=False):
        y = x + _numpy_noise(x.shape, 20)
        f = jnp.asarray(np.moveaxis(y, 2, 1)[0])  # (D, C, H, W)
        (xhat, _), _ = jm.apply(bundle[0], f, None, state=bundle[1], train=False)
        xf = np.moveaxis(x, 2, 1)[0]
        mse = np.mean((xf.astype(np.float64) - np.asarray(xhat, np.float64)) ** 2)
        p_tot += -10.0 * np.log10(mse)
        s_tot += float(jax_ssim(xhat, jnp.asarray(xf), data_range=1.0)) * xf.shape[0]
        frames += xf.shape[0]
    line = (tmp_path / "test_test_None.txt").read_text()
    assert line == f"20, PSNR: {p_tot / 2:.3f}, SSIM: {s_tot / frames:.4f}\n"
