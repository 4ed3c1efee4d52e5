"""The port's PCA noise-level estimator (nle/pca.py), its blind routes
(noise_level, Denoiser, the three eval CLIs) and its wavelet banks
(core/wavelet.py) on the CPU, against the JAX package's.

JAX's nle_pca estimates one image (img[0]); the port estimates every image
of a batch. So batches, clips and the CLIs are held to JAX applied image by
image: per image for batches, and for clips the mean of those framewise
estimates. fp32 products on both sides: the smallest eigenvalue of a patch
covariance carries ~1e-4 of relative error between two programs, and a
patch at the selection threshold may fall either way, so sigma is held at
rtol 1e-3 and the selected-patch count within 0.5%."""

import json
import os
import sys
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import cdlnet_tpu.nle as jax_nle
from cdlnet_tpu.cli import analyze as jax_analyze
from cdlnet_tpu.cli import analyze3d as jax_analyze3d
from cdlnet_tpu.cli import analyzemri as jax_analyzemri
from cdlnet_tpu.core.wavelet import filter_bank_2d as jax_filter_bank_2d
from cdlnet_tpu.nle.pca import _tau0 as jax_tau0
from cdlnet_tpu.nle.pca import nle_pca as jax_nle_pca
from cdlnet_tpu_torch.cli import analyze, analyze3d, analyzemri
from cdlnet_tpu_torch.core.wavelet import filter_bank_2d
from cdlnet_tpu_torch.data.synthetic import (
    gen_synthetic_image_dirs,
    gen_synthetic_mri_dirs,
    gen_synthetic_video_dirs,
)
from cdlnet_tpu_torch.models import CDLNetVideo
from cdlnet_tpu_torch.nle import noise_level
from cdlnet_tpu_torch.nle.pca import _tau0, nle_pca
from cdlnet_tpu_torch.serve import Denoiser

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = os.path.join(ROOT, "examples")
SIGMA_RTOL = 1e-3
JAX_NOISE_LEVEL = jax_nle.noise_level  # before any test patches it


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _noisy(shape, sigmas, seed):
    """Smooth fields along W (one per image) plus AWGN at each image's sigma
    on the 255 scale: (N, C, H, W) float32."""
    rng = np.random.default_rng(seed)
    N, C, H, W = shape
    clean = 0.5 + 0.2 * np.sin(np.linspace(0, 8, W) + rng.uniform(0, 6, (N, C, 1, 1)))
    clean = np.broadcast_to(clean, shape)
    sig = np.asarray(sigmas, np.float64).reshape(-1, 1, 1, 1) / 255.0
    return (clean + sig * rng.standard_normal(shape)).astype(np.float32)


def _jax_framewise(y, method="PCA"):
    """JAX's noise_level applied image by image, channels averaged: (N,)."""
    return np.array([float(np.mean(np.asarray(JAX_NOISE_LEVEL(jnp.asarray(y[i:i + 1]),
                                                              method))))
                     for i in range(y.shape[0])], np.float32)


@pytest.mark.parametrize("patchsize,conf", [(7, 1 - 1e-6), (5, 0.99)])
def test_tau0_matches_jax(patchsize, conf):
    assert _tau0(patchsize, conf) == jax_tau0(patchsize, conf)


@pytest.mark.parametrize("shape", [(1, 1, 128, 128), (1, 3, 64, 64)])
def test_nle_pca_matches_jax(shape):
    """sigma, tau and the selected-patch count per channel, at N = 1."""
    y = _noisy(shape, [25.0], seed=3)
    want = [np.atleast_1d(np.asarray(v)) for v in jax_nle_pca(jnp.asarray(y))]
    got = [v.numpy() for v in nle_pca(torch.from_numpy(y))]
    assert all(g.shape == (1, shape[1]) for g in got)
    np.testing.assert_allclose(got[0][0], want[0], rtol=SIGMA_RTOL)
    np.testing.assert_allclose(got[1][0], want[1], rtol=SIGMA_RTOL)
    np.testing.assert_allclose(got[2][0], want[2], rtol=5e-3)
    assert abs(255 * got[0].mean() - 25.0) < 0.15 * 25.0


def test_nle_pca_golden():
    """The reference's estimate (tests/golden/nle.npz) at JAX's rtol 1e-2,
    and JAX's own at SIGMA_RTOL."""
    g = np.load(os.path.join(ROOT, "tests", "golden", "nle.npz"))
    got = float(nle_pca(torch.from_numpy(g["y"]))[0])
    np.testing.assert_allclose(got, float(g["pca"]), rtol=1e-2)
    np.testing.assert_allclose(got, float(jax_nle_pca(jnp.asarray(g["y"]))[0]),
                               rtol=SIGMA_RTOL)


def test_noise_level_is_per_image_and_per_frame():
    """A batch of four images at four sigmas, and a clip's frames folded
    into the batch: each image's estimate is JAX's on that image alone
    (JAX's own batch call gives every image image 0's)."""
    y = _noisy((4, 1, 48, 40), [10.0, 20.0, 35.0, 50.0], seed=4)
    got = noise_level(torch.from_numpy(y), "PCA")
    assert got.shape == (4, 1, 1, 1)
    np.testing.assert_allclose(got.numpy().reshape(-1), _jax_framewise(y), rtol=SIGMA_RTOL)
    assert np.ptp(got.numpy()) > 0.1  # four different estimates
    clip = _noisy((1, 5, 40, 40), [30.0], seed=5)[:, None]  # (1, 1, D, H, W)
    frames = torch.from_numpy(clip).transpose(1, 2).reshape(5, 1, 40, 40)
    np.testing.assert_allclose(noise_level(frames, "PCA").numpy().reshape(-1),
                               _jax_framewise(frames.numpy()), rtol=SIGMA_RTOL)


def test_nle_pca_chunks_give_the_whole_batch(monkeypatch):
    """The estimate is per image, so a chunk of one image at a time gives
    the whole batch's result bit for bit."""
    y = torch.from_numpy(_noisy((3, 2, 32, 32), [15.0, 25.0, 40.0], seed=6))
    whole = nle_pca(y)
    monkeypatch.setattr("cdlnet_tpu_torch.nle.pca.CHUNK_BYTES", 1)
    for a, b in zip(nle_pca(y), whole):
        assert torch.equal(a, b)


def _tiny_video_denoiser():
    model = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=2, C=1, adaptive=True, depth=4,
                        backend="pallas")
    model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.t[:, 1].fill_(0.05)
    return model


@pytest.mark.parametrize("call", ["image", "clip", "chunk_depth", "tile_hw"])
def test_denoiser_blind_pca_runs_at_the_jax_framewise_sigma(call):
    """Denoiser(blind="PCA"): a batch of two images on the 2D cdlnet
    demo, and a clip whole, streamed in chunks and in tiles, equal the
    known-sigma call at JAX's framewise mean (per image, per clip). The
    sizes are multiples of the bucket, so nothing is padded."""
    if call == "image":
        from cdlnet_tpu_torch.train.fit import init_model

        model = init_model(_demo_args("cdlnet-demo", ""), device="cpu")[0]
        y = _noisy((2, 1, 64, 64), [15.0, 40.0], seed=7)
        sig = 255.0 * _jax_framewise(y)
        blind = Denoiser(model, blind="PCA").denoise_image_batch(y)
        known = Denoiser(model).denoise_image_batch(y, sigmas=sig)
    else:
        model = _tiny_video_denoiser()
        clip = _noisy((1, 6, 32, 32), [30.0], seed=8)[0]  # (D, H, W)
        kw = {"clip": {}, "chunk_depth": dict(chunk_depth=4, overlap=1),
              "tile_hw": dict(tile_hw=16, overlap_hw=4)}[call]
        sig = 255.0 * float(_jax_framewise(clip[:, None]).mean())
        blind = Denoiser(model, bucket=16, blind="PCA").denoise_video(clip, **kw)
        known = Denoiser(model, bucket=16).denoise_video(clip, sigma=sig, **kw)
    assert blind.shape == known.shape and np.isfinite(blind).all()
    np.testing.assert_allclose(blind, known, atol=1e-5)


def _numpy_noise(shape, sigma):
    rng = np.random.default_rng(int(sigma) * 1000 + int(np.prod(shape)) % 997)
    return (float(sigma) / 255.0 * rng.standard_normal(shape)).astype(np.float32)


def _jax_awgn(key, x, sigma):
    return x + jnp.asarray(_numpy_noise(x.shape, sigma)), jnp.asarray(sigma, jnp.float32)


def _torch_awgn(x, sigma, generator=None):
    noise = torch.from_numpy(_numpy_noise(tuple(x.shape), sigma)).to(x.device)
    return x + noise, torch.as_tensor(sigma, dtype=x.dtype, device=x.device)


def _demo_args(demo, save):
    with open(os.path.join(EXAMPLES, demo, "args.json")) as f:
        args = json.load(f)
    args["paths"] = {"save": save, "ckpt": os.path.join(EXAMPLES, demo, "net.ckpt.npz")}
    return args


@pytest.mark.parametrize("cli", ["analyze", "analyze3d", "analyzemri"])
def test_cli_blind_pca_txt_lines_match_jax(cli, tmp_path, monkeypatch):
    """--blind PCA through each eval CLI and through the JAX CLI on the same
    data, weights and noise: test_{dset}_PCA.txt's "sigma, PSNR..." lines
    agree. The 2D CLI estimates one image a batch, where JAX's estimator
    works as it is; on clips and volumes JAX's is applied frame by frame
    (its own estimates only the first frame)."""
    import cdlnet_tpu.data.noise as jax_noise

    data = str(tmp_path / "data")
    if cli == "analyze":
        gen_synthetic_image_dirs(data, n_images=2, size=128)
        demo, mods, noise = "cdlnet-demo", (jax_analyze, analyze), "awgn"
    elif cli == "analyze3d":
        gen_synthetic_video_dirs(data, n_videos=1, depth=16, size=32)
        demo, mods, noise = "cdlnet-video-demo", (jax_analyze3d, analyze3d), "awgn3d"
    else:
        gen_synthetic_mri_dirs(data, n_volumes=1, slices=4, size=64)
        demo, mods, noise = "csr-demo", (jax_analyzemri, analyzemri), "awgn3d"
    if cli != "analyze":
        monkeypatch.setattr(jax_nle, "noise_level", lambda y, method: jnp.asarray(
            _jax_framewise(np.asarray(y), method)).reshape(-1, 1, 1, 1))
    monkeypatch.setattr(jax_noise, noise, _jax_awgn)
    monkeypatch.setattr(mods[1], noise, _torch_awgn)
    argv = ["args.json", "--test", os.path.join(data, "test"), "--noise_level", "20",
            "--blind", "PCA"]
    lines = {}
    for pkg, mod in zip(("jax", "torch"), mods):
        save = str(tmp_path / pkg)
        args = _demo_args(demo, save)
        if pkg == "jax":
            mod.main(jax_analyze.build_argparser().parse_args(argv + ["--backend", "xla"]),
                     args)
        else:
            mod.main(analyze.build_argparser().parse_args(argv), args, device="cpu")
        with open(os.path.join(save, "test_test_PCA.txt")) as f:
            lines[pkg] = f.read().splitlines()
        with open(os.path.join(save, "metrics.jsonl")) as f:
            (row,) = [json.loads(x) for x in f if x.strip()]
        assert row["blind"] == "PCA" and row["sigma"] == 20.0
    (jl,), (tl,) = lines["jax"], lines["torch"]
    jf, tf = jl.split(", "), tl.split(", ")
    assert tf[0] == jf[0] == "20" and len(tf) == len(jf)
    for a, b in zip(jf[1:], tf[1:]):  # a rounding boundary may move the last digit
        va, vb = (float(v.split(": ")[-1]) for v in (a, b))
        assert abs(va - vb) <= 1.01e-3, (jl, tl)
    assert float(tf[1].split(": ")[-1]) > 20.0  # the noisy input is ~22.1 dB at sigma 20


def test_filter_bank_without_pywt_raises_as_jax_does(monkeypatch):
    monkeypatch.setitem(sys.modules, "pywt", None)  # import pywt raises ImportError
    for bank in (filter_bank_2d, jax_filter_bank_2d):
        with pytest.raises(NotImplementedError, match="pywt unavailable"):
            bank("db2")
    Wa, Ws = filter_bank_2d("bior4.4")
    np.testing.assert_array_equal(Wa, np.asarray(jax_filter_bank_2d("bior4.4")[0]))
    np.testing.assert_array_equal(Ws, np.asarray(jax_filter_bank_2d("bior4.4")[1]))


def test_filter_bank_from_pywt_matches_jax(monkeypatch):
    """Another wavelet's bank comes from pywt: through the same fake pywt,
    the port's 2D banks equal JAX's."""
    rng = np.random.default_rng(9)
    fb = rng.standard_normal((4, 6))
    fake = types.ModuleType("pywt")
    fake.Wavelet = lambda name: types.SimpleNamespace(filter_bank=tuple(map(tuple, fb)))
    monkeypatch.setitem(sys.modules, "pywt", fake)
    for got, want in zip(filter_bank_2d("fake6"), jax_filter_bank_2d("fake6")):
        assert got.shape == (4, 1, 6, 6) and got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want))
