"""CDLNetVideo's residual blocks in the port (ops/lista.py::res_block,
models/cdlnet_video.py with residual=True) on the CPU, against the
reference golden and the JAX package: the forward, the parameter
gradients, project(), the params map and checkpoints, and the train CLI."""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu.compat import import_net_state as jax_import_net_state
from cdlnet_tpu.models import CDLNetVideo as JaxCDLNetVideo
from cdlnet_tpu.train.checkpoint import load_ckpt as jax_load_ckpt
from cdlnet_tpu_torch.cli import train as cli_train
from cdlnet_tpu_torch.compat.jax_params import export_jax_params, load_jax_params
from cdlnet_tpu_torch.data.synthetic import gen_synthetic_video_dirs
from cdlnet_tpu_torch.models import CDLNetVideo
from cdlnet_tpu_torch.models import cdlnet_video
from cdlnet_tpu_torch.train.checkpoint import load_params
from cdlnet_tpu_torch.train.fit import init_model

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SMALL = dict(K=2, M=4, P=(3, 3, 3), s=2, C=1, adaptive=True, depth=4, residual=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_kernels(monkeypatch):
    """The kernel entry points of CDLNetVideo raise if reached: residual
    models run the plain loop on every backend."""
    def boom(*a, **k):
        raise AssertionError("a residual model reached the hand kernels")

    monkeypatch.setattr(cdlnet_video, "lista3d_fused", boom)
    monkeypatch.setattr(cdlnet_video, "lista3d_fused_diff", boom)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("backend", ["xla", "cuda"])
def test_cdlnet3d_residual_golden(backend, no_kernels):
    """The reference torch forward with residual blocks (sd:: state dict),
    loaded through JAX's import_net_state, at the JAX golden tolerance."""
    data = np.load(os.path.join(GOLDEN, "cdlnet3d_res.npz"))
    sd = {k[4:]: data[k] for k in data.files if k.startswith("sd::")}
    cfg = dict(K=2, M=4, P=(3, 3, 3), s=1, C=1, adaptive=True, residual=True)
    params = _np(jax_import_net_state(JaxCDLNetVideo(**cfg), sd))
    model = load_jax_params(CDLNetVideo(**cfg, backend=backend), params)
    with torch.no_grad():
        xhat, z = model(torch.from_numpy(data["x"]), float(data["sigma"]), return_z=True)
    np.testing.assert_allclose(xhat.numpy(), data["xhat"], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(z.numpy(), data["z"], rtol=1e-4, atol=5e-5)


@pytest.fixture(scope="module")
def small_params():
    """JAX-initialized params (power method, kaiming residual blocks) with
    seeded positive thresholds."""
    params = _np(JaxCDLNetVideo(**SMALL).init(jax.random.PRNGKey(0)))
    params["t"] = (0.05 * np.random.default_rng(0).uniform(size=params["t"].shape)
                   ).astype(np.float32)
    return params


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.2, 0.8, (2, 1, 4, 12, 12)).astype(np.float32)
    sigma = np.array([15.0, 30.0], np.float32)
    noisy = clean + (sigma / 255.0).reshape(-1, 1, 1, 1, 1) * rng.standard_normal(
        clean.shape).astype(np.float32)
    return clean, noisy.astype(np.float32), sigma


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-30))


@pytest.mark.parametrize("backend", ["xla", "cuda"])
def test_forward_codes_and_gradients_match_jax(backend, small_params, no_kernels):
    """xhat, every iteration's codes, and the gradient of the mse to every
    parameter (A, B, t and both residual banks), per-sample sigma, against
    JAX's apply and jax.grad."""
    jm = JaxCDLNetVideo(**SMALL)
    clean, noisy, sigma = _batch()
    model = load_jax_params(CDLNetVideo(**SMALL, backend=backend), small_params)

    def jax_loss(p):
        return jnp.mean((jm.apply(p, jnp.asarray(noisy), jnp.asarray(sigma))[0] - clean) ** 2)

    jgrads = _np(jax.grad(jax_loss)(jax.tree_util.tree_map(jnp.asarray, small_params)))
    xhat = model(torch.from_numpy(noisy), torch.from_numpy(sigma))[0]
    loss = torch.mean((xhat - torch.from_numpy(clean)) ** 2)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    assert sorted(names) == ["A", "B", "residual.conv1", "residual.conv2", "t"]
    want = jm.apply(small_params, jnp.asarray(noisy), jnp.asarray(sigma))[0]
    assert _rel(xhat.detach().numpy(), want) <= 1e-5
    for name in names:
        node = jgrads
        for part in name.split("."):
            node = node[part]
        assert _rel(grads[name].numpy(), node) <= 1e-4, name
    with torch.no_grad():
        _, z, codes = model.apply_with_codes(torch.from_numpy(noisy), torch.from_numpy(sigma))
    _, _, jcodes = jm.apply_with_codes(small_params, jnp.asarray(noisy), jnp.asarray(sigma))
    assert codes.shape == (2, 2, 4, 2, 6, 6) and torch.equal(codes[-1], z)
    assert _rel(codes.numpy(), jcodes) <= 1e-5


def test_project_leaves_the_residual_blocks_as_they_are(small_params):
    params = dict(small_params, A=3.0 * small_params["A"], B=3.0 * small_params["B"],
                  t=small_params["t"] - 0.03)
    model = load_jax_params(CDLNetVideo(**SMALL), params)
    model.project()
    want = _np(JaxCDLNetVideo(**SMALL).project(jax.tree_util.tree_map(jnp.asarray, params)))
    got = export_jax_params(model)
    for name in ("A", "B", "t"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-7)
    for name in ("conv1", "conv2"):
        np.testing.assert_array_equal(got["residual"][name], params["residual"][name])
        np.testing.assert_array_equal(want["residual"][name], params["residual"][name])


def test_params_map_and_init(small_params):
    """JAX's nested params load by name into the ParameterDict and export
    back unchanged; the port's own init draws kaiming-style blocks of
    std sqrt(2 / (27 M)); without residual=True there is no residual."""
    model = load_jax_params(CDLNetVideo(**SMALL), small_params)
    back = export_jax_params(model)
    assert set(back) == {"A", "B", "t", "residual"}
    for name in ("conv1", "conv2"):
        assert back["residual"][name].shape == (2, 4, 4, 3, 3, 3)
        np.testing.assert_array_equal(back["residual"][name], small_params["residual"][name])
    wide = CDLNetVideo(**dict(SMALL, M=24, K=3)).init(torch.Generator().manual_seed(0),
                                                       init=False)
    for w in wide.residual.values():
        assert abs(float(w.detach().std()) / (2.0 / (27 * 24)) ** 0.5 - 1) < 0.05
    assert CDLNetVideo(K=2, M=4).residual is None
    assert "residual" not in export_jax_params(CDLNetVideo(K=2, M=4))


def test_train_cli_trains_a_residual_cdlnet_video(tmp_path, no_kernels):
    """cli.train.main from an args.json with residual: true (backend
    "pallas", which residual models leave for the plain loop): two epochs,
    finite PSNRs, and a checkpoint that reloads through the saved args.json
    in the port and in the JAX package."""
    data = gen_synthetic_video_dirs(str(tmp_path / "data"), n_videos=2, depth=4, size=16)
    save = str(tmp_path / "run")
    args = {"type": "CDLNetVideo",
            "model": dict(SMALL, P=[3, 3, 3], backend="pallas", init=True),
            "paths": {"save": save, "ckpt": None},
            "train": {"opt": {"lr": 1e-3},
                      "fit": {"epochs": 2, "noise_std": [20, 30], "val_freq": 1,
                              "save_freq": 1, "clip_grad": 0.05, "verbose": False,
                              "backtrack_thresh": None},
                      "loaders": {f"{k}_path_list": [os.path.join(data, split)]
                                  for k, split in (("trn", "train"), ("val", "val"),
                                                   ("tst", "test"))}
                      | {"crop_size": 8, "depth": 4, "batch_size": [2, 1, 1],
                         "num_workers": 2}}}
    init = init_model(args, device="cpu")[0]
    state, history = cli_train.main(args, device="cpu")
    assert [(e, ph) for e, ph, _ in history] == [
        (1, "train"), (1, "val"), (2, "train"), (2, "val"), (2, "test")]
    assert all(np.isfinite(p) for _, _, p in history) and int(state["count"]) == 2
    with open(os.path.join(save, "args.json")) as f:
        saved = json.load(f)
    back, _, back_state, epoch, _ = init_model(saved, device="cpu")
    assert epoch == 2 and int(back_state["count"]) == 2
    params, _ = load_params(saved["paths"]["ckpt"])
    for name in ("conv1", "conv2"):
        np.testing.assert_array_equal(back.residual[name].detach().numpy(),
                                      params["residual"][name])
        assert not torch.equal(back.residual[name], init.residual[name])  # trained
    jparams = jax_load_ckpt(saved["paths"]["ckpt"],
                            JaxCDLNetVideo(**SMALL).init(jax.random.PRNGKey(0)))[0]
    np.testing.assert_array_equal(np.asarray(jparams["residual"]["conv2"]),
                                  params["residual"]["conv2"])
