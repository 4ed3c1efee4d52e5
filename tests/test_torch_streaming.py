"""cdlnet_tpu_torch/models/streaming.py and Denoiser.denoise_video's
streamed and tiled routes on the CPU, against the JAX package's
models/streaming.py and Denoiser on the same inputs (the cases of
tests/test_streaming.py): overlap-discard chunking in depth, the
pipelined host loop, spatial tiling, and the routing of denoise_video.

Weights and clips are seeded numpy arrays given to both packages; the
port runs backend "xla" (the plain loop, the JAX backend it is compared
with) and "pallas" (the kernels' plain versions on the CPU)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cdlnet_tpu import nle as jax_nle
from cdlnet_tpu.models import CDLNetVideo as JaxCDLNetVideo
from cdlnet_tpu.models import streaming as jax_streaming
from cdlnet_tpu.serve import Denoiser as JaxDenoiser
from cdlnet_tpu_torch.compat.jax_params import load_jax_params
from cdlnet_tpu_torch.models import CDLNetVideo, streaming
from cdlnet_tpu_torch.serve import Denoiser


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LONG = dict(K=6, M=8, P=(5, 5, 3), s=2, C=1, adaptive=True, depth=8)
BIG = dict(K=4, M=8, P=(7, 7, 3), s=2, C=1, adaptive=True, depth=8)
ATOL = 1e-5  # the same fp32 convolutions summed in another order


def _params(cfg, seed=0):
    """0.05-scaled random banks shared by every A_k and B_k, and positive
    thresholds as in a trained model (t = 0 turns off the shrinkage that
    makes the coupling between chunks decay)."""
    rng = np.random.default_rng(seed)
    W = 0.05 * rng.standard_normal((cfg["M"], cfg["C"], *cfg["P"])).astype(np.float32)
    K = cfg["K"]
    return {"A": np.repeat(W[None], K, 0), "B": np.repeat(W[None], K, 0),
            "t": np.full((K, 2, cfg["M"], 1, 1, 1), 0.02, np.float32)}


def _models(cfg, backend="xla"):
    params = _params(cfg)
    jm = JaxCDLNetVideo(**cfg)
    return jm, params, load_jax_params(CDLNetVideo(**cfg, backend=backend), params)


def _clip(shape, seed=1):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(size=shape).astype(np.float32)
    return clean + 0.1 * rng.standard_normal(shape).astype(np.float32)


def _agree_db(got, ref):
    return 10 * np.log10(np.mean(ref**2) / max(np.mean((got - ref) ** 2), 1e-20))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("overlap", [2, 6])
def test_long_video_matches_jax(backend, overlap):
    jm, params, model = _models(LONG, backend)
    y = _clip((1, 1, 32, 24, 24))
    want = jax_streaming.denoise_long_video(jm, params, jnp.asarray(y), 25.0,
                                            chunk_depth=16, overlap=overlap)
    got = streaming.denoise_long_video(model, torch.from_numpy(y), 25.0,
                                       chunk_depth=16, overlap=overlap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with torch.inference_mode():
        full = model(torch.from_numpy(y), 25.0)[0].numpy()
    assert _agree_db(got.numpy(), full) > 30  # the chunk borders' only cost


def test_long_video_short_clip_and_bad_overlap():
    _, _, model = _models(LONG)
    y = torch.from_numpy(_clip((1, 1, 12, 24, 24)))
    with torch.inference_mode():
        full = model(y, 25.0)[0]
    torch.testing.assert_close(streaming.denoise_long_video(model, y, 25.0), full,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="must exceed"):
        streaming.denoise_long_video(model, torch.zeros(1, 1, 32, 8, 8), 25.0,
                                     chunk_depth=8, overlap=4)


def test_pipelined_matches_jax_and_the_staged_loop():
    cfg = dict(K=2, M=4, P=(3, 3, 3), s=2, C=1, adaptive=True, depth=4)
    jm, params, model = _models(cfg, "pallas")
    clip = np.random.default_rng(0).uniform(0, 1, (1, 1, 24, 16, 16)).astype(np.float32)
    want = jax_streaming.denoise_long_video_pipelined(jm, params, clip, 25.0,
                                                      chunk_depth=8, overlap=2)
    got = streaming.denoise_long_video_pipelined(model, clip, 25.0, chunk_depth=8,
                                                 overlap=2)
    staged = streaming.denoise_long_video(model, torch.from_numpy(clip), 25.0,
                                          chunk_depth=8, overlap=2)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got, staged.numpy())
    short = streaming.denoise_long_video_pipelined(model, clip[:, :, :8], 25.0,
                                                   chunk_depth=8, overlap=2)
    with torch.inference_mode():
        full = model(torch.from_numpy(clip[:, :, :8]), 25.0)[0].numpy()
    np.testing.assert_array_equal(short, full)


@pytest.mark.parametrize("overlap_hw", [8, 16])
def test_tiled_matches_jax(overlap_hw):
    jm, params, model = _models(BIG, "pallas")
    y = _clip((1, 1, 8, 96, 96))
    want = jax_streaming.denoise_video_tiled(jm, params, jnp.asarray(y), 25.0,
                                             chunk_depth=8, tile_hw=48,
                                             overlap_hw=overlap_hw)
    got = streaming.denoise_video_tiled(model, torch.from_numpy(y), 25.0, chunk_depth=8,
                                        tile_hw=48, overlap_hw=overlap_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_tiled_small_frame_and_bad_overlap():
    _, _, model = _models(BIG)
    y = torch.from_numpy(_clip((1, 1, 8, 32, 32)))
    with torch.inference_mode():
        full = model(y, 25.0)[0]
    got = streaming.denoise_video_tiled(model, y, 25.0, chunk_depth=8, tile_hw=64)
    torch.testing.assert_close(got, full, rtol=0, atol=0)
    with pytest.raises(ValueError, match="must exceed"):
        streaming.denoise_video_tiled(model, torch.zeros(1, 1, 8, 96, 96), 25.0,
                                      chunk_depth=8, tile_hw=32, overlap_hw=16)


@pytest.mark.parametrize("route", ["chunk_depth", "tile_hw", "chunk_and_tile"])
def test_denoise_video_matches_jax_denoiser(route):
    """The routes of denoise_video against the JAX Denoiser's on backend
    "xla": streamed after the bucket pad, tiled without it."""
    jm, params, model = _models(BIG)
    clip = _clip((20, 40, 52), seed=5)  # buckets to 64x64
    kw = {"chunk_depth": dict(chunk_depth=8, overlap=2),
          "tile_hw": dict(tile_hw=(32, 40), overlap_hw=8),
          "chunk_and_tile": dict(chunk_depth=8, overlap=2, tile_hw=32, overlap_hw=8),
          }[route]
    want = JaxDenoiser(jm, params).denoise_video(clip, sigma=25.0, **kw)
    got = Denoiser(model).denoise_video(clip, sigma=25.0, **kw)
    assert got.shape == clip.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_denoise_video_stages_or_pipelines_alike(monkeypatch):
    """A clip over the staging limit takes the pipelined host loop, with
    the same output; blind sigma is estimated once per clip over all its
    frames, as the whole-clip route does."""
    _, _, model = _models(BIG, "pallas")
    d = Denoiser(model)
    clip = np.stack([_clip((20, 40, 52), seed=6), _clip((20, 40, 52), seed=7)])[:, None]
    sig = [15.0, 30.0]
    staged = d.denoise_video(clip, sigma=sig, chunk_depth=8, overlap=2)
    monkeypatch.setattr(Denoiser, "staging_limit", lambda self: 0)
    piped = d.denoise_video(clip, sigma=sig, chunk_depth=8, overlap=2)
    np.testing.assert_array_equal(piped, staged)
    padded = np.pad(clip, [(0, 0)] * 3 + [(0, 24), (0, 12)], mode="reflect")
    with torch.inference_mode():
        whole = d._blind_sigma(torch.from_numpy(padded)).numpy()
    np.testing.assert_allclose(d._clip_sigma(padded, None, 8), whole, rtol=1e-5)
    blind = d.denoise_video(clip, chunk_depth=8, overlap=2)
    np.testing.assert_allclose(blind, d.denoise_video(clip, sigma=whole, chunk_depth=8,
                                                      overlap=2), atol=1e-5)


@pytest.mark.parametrize("route,shape", [("chunk_depth", (20, 40, 52)),
                                         ("tile_hw", (20, 64, 64))])
def test_blind_denoise_video_matches_jax_whole_clip_estimate(route, shape):
    """Blind streamed and tiled routes run at the sigma that the JAX
    Denoiser's whole-clip blind route estimates: the mean of the framewise
    MAD estimates over the bucket-padded clip (the tiled route takes no
    pad, so its clip is bucket-sized here). The JAX Denoiser's own streamed
    and tiled routes pass sigma None to the model instead (c = 0 on an
    adaptive model), so they are given that estimate."""
    jm, params, model = _models(BIG)
    clip = _clip(shape, seed=8)
    kw = {"chunk_depth": dict(chunk_depth=8, overlap=2),
          "tile_hw": dict(tile_hw=32, overlap_hw=8)}[route]
    H, W = shape[1:]
    padded = np.pad(clip, [(0, 0), (0, -H % 64), (0, -W % 64)], mode="reflect")
    est = 255.0 * float(np.mean(np.asarray(jax_nle.noise_level(
        jnp.asarray(padded[:, None]), method="MAD"))))
    want = JaxDenoiser(jm, params).denoise_video(clip, sigma=est, **kw)
    got = Denoiser(model).denoise_video(clip, **kw)
    np.testing.assert_allclose(got, want, atol=ATOL)
