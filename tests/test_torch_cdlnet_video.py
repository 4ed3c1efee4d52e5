"""cdlnet_tpu_torch's CDLNetVideo, checkpoint reader, params map and
Denoiser against the reference goldens and the JAX package."""

import json
import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu.models import CDLNetVideo as JaxCDLNetVideo
from cdlnet_tpu.serve import Denoiser as JaxDenoiser
from cdlnet_tpu.train.checkpoint import load_ckpt
from cdlnet_tpu_torch.compat.jax_params import export_jax_params, load_jax_params
from cdlnet_tpu_torch.models import CDLNetVideo, build_model
from cdlnet_tpu_torch.serve import Denoiser
from cdlnet_tpu_torch.train.checkpoint import load_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "tests", "golden")
DEMO = os.path.join(ROOT, "examples", "cdlnet-video-demo")


def _golden(name):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    sd = {k[4:]: data[k] for k in data.files if k.startswith("sd::")}
    return sd, {k: data[k] for k in data.files if not k.startswith("sd::")}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_cdlnet3d_golden(backend):
    """The reference torch forward (sd:: state dict with per-iteration
    A.{k}/B.{k} convs), held at the JAX golden tolerance."""
    sd, g = _golden("cdlnet3d")
    model = CDLNetVideo(K=3, M=6, P=(5, 5, 3), s=2, C=1, adaptive=True,
                        backend=backend)
    load_jax_params(model, {
        "A": np.stack([sd[f"A.{k}.weight"] for k in range(3)]),
        "B": np.stack([sd[f"B.{k}.weight"] for k in range(3)]),
        "t": sd["t"],
    })
    with torch.no_grad():
        xhat, z = model(torch.from_numpy(g["x"]), float(g["sigma"]), return_z=True)
    np.testing.assert_allclose(xhat.numpy(), g["xhat"], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(z.numpy(), g["z"], rtol=1e-4, atol=5e-5)


SMALL = dict(K=3, M=8, P=(7, 7, 5), s=2, C=1, adaptive=True, depth=4)


@pytest.fixture(scope="module")
def small_params():
    """JAX-initialized (power-method normalized) params, thresholds > 0."""
    params = jax.tree_util.tree_map(
        np.asarray, JaxCDLNetVideo(**SMALL).init(jax.random.PRNGKey(0), init=True))
    params["t"] = np.abs(np.random.default_rng(0).standard_normal(
        params["t"].shape)).astype(np.float32) * 0.05
    return params


def _small_pair(backend, params):
    return JaxCDLNetVideo(**SMALL), load_jax_params(CDLNetVideo(**SMALL, backend=backend),
                                                    params)


@pytest.mark.parametrize("backend,use_mask", [("xla", False), ("pallas", False),
                                              ("pallas", True)])
def test_model_matches_jax_apply(backend, use_mask, small_params):
    params = small_params
    jm, tm = _small_pair(backend, params)
    rng = np.random.default_rng(1)
    y = rng.uniform(size=(2, 1, 7, 18, 22)).astype(np.float32)  # odd sizes pad
    sigma = np.array([15.0, 35.0], np.float32)
    mask = (rng.uniform(size=y.shape) > 0.3).astype(np.float32) if use_mask else None
    xj, zj = jm.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(y),
                      jnp.asarray(sigma),
                      mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        xt, zt = tm(torch.from_numpy(y), torch.from_numpy(sigma),
                    mask=None if mask is None else torch.from_numpy(mask),
                    return_z=True)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4)


def test_project_matches_jax(small_params):
    params = dict(small_params, A=small_params["A"] * 3.0, t=small_params["t"] - 0.03)
    jm, tm = _small_pair("xla", params)
    want = jm.project(jax.tree_util.tree_map(jnp.asarray, params))
    got = export_jax_params(tm.project())
    for k in ("A", "B", "t"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-6)


def test_init_is_spectrally_normalized_and_seeded():
    cfg = dict(K=2, M=4, P=(5, 5, 3), s=2, C=1, depth=4)
    a = CDLNetVideo(**cfg).init(torch.Generator().manual_seed(3))
    b = CDLNetVideo(**cfg).init(torch.Generator().manual_seed(3))
    torch.testing.assert_close(a.A, b.A, rtol=0, atol=0)
    assert torch.equal(a.A, a.B) and torch.equal(a.A[0], a.A[1])
    # ||D D^T|| after normalization: the power method on the new W gives ~1
    from cdlnet_tpu_torch.core.solvers import power_method
    from cdlnet_tpu_torch.ops.conv import conv3d, conv_transpose3d

    W, pad = a.A[0].detach(), a.pad
    L, _, _ = power_method(
        lambda x: conv_transpose3d(conv3d(x, W, stride=2, padding=pad), W, stride=2,
                                   padding=pad, output_padding=1),
        torch.rand(1, 1, 4, 32, 32, generator=torch.Generator().manual_seed(0)),
        num_iter=100)
    assert 0.9 < float(L) <= 1.01


def test_checkpoint_reader_and_params_roundtrip():
    ck = os.path.join(DEMO, "net.ckpt.npz")
    params, meta = load_params(ck)
    model = build_model("CDLNetVideo", {"K": 8, "M": 32, "P": [5, 5, 3], "s": 2,
                                        "adaptive": True, "init": True})
    jparams, _, epoch, _ = load_ckpt(ck, JaxCDLNetVideo(K=8, M=32, P=(5, 5, 3), s=2)
                                     .init(jax.random.PRNGKey(0), init=False))
    assert meta.get("epoch", 0) == epoch
    back = export_jax_params(load_jax_params(model, params))
    assert sorted(back) == sorted(jparams) == ["A", "B", "t"]
    for k in back:
        np.testing.assert_array_equal(back[k], np.asarray(jparams[k]))


def test_demo_denoiser_matches_jax(tmp_path):
    """Denoiser.from_dir on a copied model dir (recorded ckpt path gone, so it
    re-anchors) gives the JAX Denoiser's output."""
    dst = tmp_path / "moved"
    dst.mkdir()
    shutil.copy(os.path.join(DEMO, "net.ckpt.npz"), dst / "net.ckpt.npz")
    with open(os.path.join(DEMO, "args.json")) as f:
        args = json.load(f)
    args["paths"]["ckpt"] = "/nonexistent/dir/net.ckpt.npz"
    (dst / "args.json").write_text(json.dumps(args))
    rng = np.random.default_rng(0)
    tt, yy, xx = np.meshgrid(np.linspace(-np.pi, np.pi, 16), np.linspace(-np.pi, np.pi, 64),
                             np.linspace(-np.pi, np.pi, 64), indexing="ij")
    clean = (0.5 + 0.3 * np.sin(2 * xx + 1) * np.cos(1.5 * yy) * np.cos(tt)).astype(np.float32)
    noisy = (clean + 25 / 255 * rng.standard_normal(clean.shape)).astype(np.float32)
    ours = Denoiser.from_dir(str(dst), device="cpu").denoise_video(noisy[None, None],
                                                                   sigma=25)
    theirs = JaxDenoiser.from_dir(str(dst), backend="xla").denoise_video(
        noisy[None, None], sigma=25)
    assert ours.shape == (1, 1, 16, 64, 64)
    np.testing.assert_allclose(ours, theirs, atol=1e-4)
    assert np.mean((ours - clean) ** 2) < 0.5 * np.mean((noisy - clean) ** 2)


def test_denoiser_defaults_to_the_card(monkeypatch):
    """With no device the Denoiser runs on the card, and without one it
    raises instead of taking the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Denoiser.from_dir(DEMO)
    assert Denoiser.from_dir(DEMO, device="cpu").device.type == "cpu"


def _tiny_denoiser(backend="pallas"):
    model = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=2, adaptive=True, depth=4,
                        backend=backend).init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.t.fill_(0.02)
    return Denoiser(model, bucket=16)


def test_per_sample_sigma_in_one_forward():
    d = _tiny_denoiser()
    rng = np.random.default_rng(4)
    clips = rng.uniform(size=(2, 1, 4, 20, 12)).astype(np.float32)
    both = d.denoise_video(clips, sigma=[10.0, 40.0])
    assert both.shape == clips.shape
    for i, s in enumerate((10.0, 40.0)):
        one = d.denoise_video(clips[i], sigma=s)
        np.testing.assert_allclose(both[i], one, atol=1e-5)
    assert not np.allclose(both[0], d.denoise_video(clips[0], sigma=40.0), atol=1e-3)
    with pytest.raises(ValueError):
        d.denoise_video(clips, sigma=[10.0, 20.0, 30.0])


@pytest.mark.parametrize("call", ["mesh", "torch_ckpt", "unknown_type"])
def test_unported_paths_raise(call, tmp_path):
    """Mesh serving, torch .ckpt files and DnCNN are ported
    (tests/test_torch_dist*.py, tests/test_torch_ckpt.py,
    tests/test_torch_dncnn.py; the cases keep their names): on one process
    Denoiser(mesh=) serves on the trivial mesh, equal to the meshless
    call; a .ckpt's net state needs the model config to map onto params,
    and an unknown type raises. Blind PCA (whole, chunked, tiled) and
    residual blocks are ported: tests/test_torch_nle_pca.py and
    tests/test_torch_residual.py."""
    if call == "mesh":
        d = _tiny_denoiser()
        clip = np.random.default_rng(0).uniform(size=(8, 32, 32)).astype(np.float32)
        np.testing.assert_array_equal(
            Denoiser(d.model, bucket=16, mesh={"data": -1}).denoise_video(clip, sigma=25),
            d.denoise_video(clip, sigma=25))
    elif call == "torch_ckpt":
        from cdlnet_tpu_torch.compat.torch_ckpt import save_torch_checkpoint

        model = _tiny_denoiser().model
        save_torch_checkpoint(str(tmp_path / "net.ckpt"), model, epoch=3)
        with pytest.raises(ValueError, match="model config"):
            load_params(str(tmp_path / "net.ckpt"))
        params, meta = load_params(str(tmp_path / "net.ckpt"), model)
        assert meta["epoch"] == 3
        np.testing.assert_array_equal(params["A"], model.A.detach().numpy())
    else:
        with pytest.raises(NotImplementedError, match="unknown model type"):
            build_model("DnCNN3D", {"K": 2})
        assert type(build_model("DnCNN", {"K": 3})).__name__ == "DnCNN"
