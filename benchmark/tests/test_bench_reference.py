"""The benchmark's plain reference against the port's plain paths, on the
CPU at tiny sizes: the LISTA forwards (2D and 3D, odd sizes, one sigma a
sample), the Denoiser's bucket pad and blind MAD, a training step (clipped
Adam and the projection) and the corpora's crop protocol. The control's
TF32 rounding is checked too."""

import bench_tiny  # noqa: F401  (sys.path)
import numpy as np
import pytest
import torch

from benchlib import synth
from reference import corpus as ref_corpus
from reference.lista import bucket_pad, lista_forward, to_tf32
from reference.mad import mad_sigma
from reference.train import train_steps

CPU = torch.device("cpu")
VIDEO = dict(K=4, M=6, P=[3, 5, 3], s=2, C=1, adaptive=True, depth=4)
IMAGE = dict(K=4, M=6, P=5, s=2, C=1, adaptive=True)


def _model(cfg, backend="xla"):
    from cdlnet_tpu_torch.models.base import build_model

    kind = "CDLNetVideo" if "depth" in cfg else "CDLNet"
    model = build_model(kind, dict(cfg, backend=backend))
    W = synth.weights(cfg, 3, CPU)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(W[n])
    return model, W


@pytest.mark.parametrize("cfg, shape", [(VIDEO, (2, 1, 5, 13, 11)), (IMAGE, (3, 1, 17, 22))])
def test_forward_matches_the_port(cfg, shape):
    model, W = _model(cfg)
    y = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    sigma = torch.tensor([20.0, 27.5, 30.0][: shape[0]])
    with torch.no_grad():
        want = model(y, sigma)[0]
    got = lista_forward(W["A"], W["B"], W["t"], y, sigma, cfg["s"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_denoiser_bucket_and_blind_sigma_match_the_port():
    from cdlnet_tpu_torch.serve import Denoiser

    model, W = _model(IMAGE, backend="pallas")  # plain versions on the CPU
    d = Denoiser(model, bucket=16)
    img = np.random.default_rng(2).random((21, 35)).astype(np.float32)
    want = d.denoise_image(img)
    yp = bucket_pad(torch.from_numpy(img)[None, None], 16)
    sigma = 255.0 * mad_sigma(yp).mean()
    got = lista_forward(W["A"], W["B"], W["t"], yp, sigma, IMAGE["s"])[0, 0, :21, :35]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_clip_bucket_matches_numpy_reflect():
    y = torch.rand(1, 1, 3, 10, 7)
    want = np.pad(y.numpy(), [(0, 0)] * 3 + [(0, 6), (0, 1)], mode="reflect")
    np.testing.assert_array_equal(bucket_pad(y, 8).numpy(), want)


def test_mad_matches_the_port():
    from cdlnet_tpu_torch.nle.mad import nle_mad

    y = torch.rand(4, 1, 40, 52, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(mad_sigma(y), nle_mad(y).reshape(-1))


@pytest.mark.parametrize("cfg, shape", [(VIDEO, (2, 1, 4, 12, 12)), (IMAGE, (3, 1, 12, 12))])
def test_train_steps_match_the_port(cfg, shape):
    from cdlnet_tpu_torch.train.fit import train_update
    from cdlnet_tpu_torch.train.optim import make_optimizer

    model, W = _model(cfg)
    opt = make_optimizer(1e-3, clip_grad=1)
    state = opt.init(dict(model.named_parameters()))
    g = torch.Generator().manual_seed(5)
    batches = []
    for _ in range(3):
        clean = torch.rand(shape, generator=g)
        sigma = 20 + 10 * torch.rand(shape[0], generator=g)
        noisy = clean + sigma.view(-1, *[1] * (len(shape) - 1)) / 255 * torch.randn(
            shape, generator=g)
        batches.append((noisy, sigma, clean))
    losses = [float(train_update(model, opt, state, y, s.view(-1, *[1] * (len(shape) - 1)), x))
              for y, s, x in batches]
    ref = train_steps(W, batches, cfg["s"], 1e-3, 1.0)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), ref["params"][n], rtol=1e-4, atol=1e-6)


def test_image_crops_match_the_port():
    from cdlnet_tpu_torch.train.device_data import DeviceImageCorpus

    rng = np.random.default_rng(6)
    images = [rng.random((1, 21, 30) if i % 2 == 0 else (1, 30, 21)).astype(np.float32)
              for i in range(8)]
    corpus = DeviceImageCorpus(images, 9, 4, device="cpu")
    g = torch.Generator().manual_seed(7)
    for _ in range(5):
        idx = corpus.epoch_perm(g)[:4]
        draws = corpus.draw(idx, g)
        batch = corpus.assemble(idx, *draws)
        for b, i in enumerate(idx.tolist()):
            oh, ow, fh, fv = (int(d[b]) for d in draws)
            size = (21, 30)
            assert not ref_corpus.check_image_draws([0], [oh], [ow], [size], 9)
            want = ref_corpus.image_crop(torch.from_numpy(images[i]), 9, i % 2 == 1, oh, ow,
                                         bool(fh), bool(fv))
            torch.testing.assert_close(batch[b], want, rtol=0, atol=0)


def test_clip_crops_match_the_port():
    from cdlnet_tpu_torch.train.device_data import DeviceClipCorpus

    rng = np.random.default_rng(8)
    videos = [rng.random((1, 9, 20, 26)).astype(np.float32) for _ in range(5)]
    corpus = DeviceClipCorpus(videos, 4, (8, 8), 2, crop_ratio=0.5, aug_prob=0.4, max_shift=3,
                              device="cpu")
    g = torch.Generator().manual_seed(9)
    for _ in range(12):
        idx = corpus.epoch_perm(g)[:2]
        draws = corpus.draw(idx, g)
        batch = corpus.assemble(idx, *draws)
        for b, i in enumerate(idx.tolist()):
            walk, start_w, x0, y0, st, start_c, rev, do_crop, cx, cy = (d[b] for d in draws)
            args = (bool(walk), int(start_w), int(x0), int(y0), st, int(start_c), bool(rev),
                    bool(do_crop), int(cx), int(cy))
            assert not ref_corpus.check_clip_draws(9, 4, (20, 26), (8, 8), 3, *args)
            want = ref_corpus.clip_frames(torch.from_numpy(videos[i]), 4, (8, 8), 3, *args)
            torch.testing.assert_close(batch[b], want, rtol=0, atol=1e-6)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-12, -3.14159265, 0.0, 6.0e-39])
    r = to_tf32(x)
    assert r.tolist()[:5] == [1.0, 1 + 2**-10, 1.0, -3.140625, 0.0]
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    w = torch.rand(5, requires_grad=True)
    to_tf32(w).sum().backward()
    assert w.grad.tolist() == [1.0] * 5
