"""cdlnet_tpu_torch's HTTP server against the JAX package's: the nine cases
of tests/test_server.py on a live in-process port server on the CPU, its
outputs held to the JAX Denoiser (backend "xla") on the same weights, /info
held to JAX's server, the device lock, and main()'s refusal to serve on
the CPU unless asked."""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import jax
import torch

from cdlnet_tpu.models import CDLNet as JaxCDLNet
from cdlnet_tpu.models import CDLNetVideo as JaxCDLNetVideo
from cdlnet_tpu.serve import Denoiser as JaxDenoiser
from cdlnet_tpu.server import DenoiseServer as JaxDenoiseServer
from cdlnet_tpu_torch import server as server_mod
from cdlnet_tpu_torch.compat.jax_params import load_jax_params
from cdlnet_tpu_torch.models import CDLNet, CDLNetVideo
from cdlnet_tpu_torch.serve import Denoiser
from cdlnet_tpu_torch.server import DenoiseServer, _dump_npy, _parse_npy

TOL = 1e-5
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
CFG = dict(K=2, M=6, P=5, s=2, adaptive=True)
VIDEO_CFG = dict(K=2, M=6, P=(5, 5, 3), s=2, adaptive=True, depth=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(jax_cls, cls, cfg):
    """The JAX Denoiser (backend "xla") and the port's (the kernels' plain
    versions, backend "pallas") on the weights of JAX's init, with
    thresholds > 0 so that sigma reaches the output."""
    jm = jax_cls(**cfg)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), init=True))
    params["t"] = 0.05 * np.abs(np.random.default_rng(0).standard_normal(
        params["t"].shape)).astype(np.float32)
    model = load_jax_params(cls(**cfg, backend="pallas"), params)
    return JaxDenoiser(jm, params, bucket=16), Denoiser(model, bucket=16)


@pytest.fixture(scope="module")
def denoisers():
    return _pair(JaxCDLNet, CDLNet, CFG)


@pytest.fixture(scope="module")
def server(denoisers):
    srv = DenoiseServer(denoisers[1], port=0).start()
    yield srv
    srv.stop()


def _url(srv, path, **params):
    q = "&".join(f"{k}={v}" for k, v in params.items())
    return f"http://127.0.0.1:{srv.port}{path}" + (f"?{q}" if q else "")


def _post(srv, path, arr, **params):
    req = urllib.request.Request(
        _url(srv, path, **params), data=_dump_npy(arr),
        headers={"Content-Type": "application/x-npy"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


def _post_error(srv, path, body, **params):
    req = urllib.request.Request(_url(srv, path, **params), data=body, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    return e.value.code, json.loads(e.value.read())


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=30) as r:
        return r.status, r.read()


def test_healthz_and_info_match_jax(server, denoisers):
    status, body = _get(server, "/healthz")
    assert status == 200 and body == b"ok"
    status, body = _get(server, "/info")
    info = json.loads(body)
    jsrv = JaxDenoiseServer(denoisers[0], port=0).start()
    try:
        want = json.loads(_get(jsrv, "/info")[1])
    finally:
        jsrv.stop()
    assert status == 200 and sorted(info) == sorted(want)
    assert info["model"] == want["model"] == "CDLNet"
    assert info["n_params"] == want["n_params"] > 0
    assert (info["blind"], info["bucket"]) == (want["blind"], want["bucket"])
    for k in ("K", "M", "P", "s", "C", "t0", "adaptive"):
        assert info["config"][k] == want["config"][k], k
    assert info["config"]["backend"] == "pallas"


def test_denoise_image_roundtrip_matches_jax(server, denoisers):
    """Known sigma and blind (MAD), each a lone request through the
    coalescer, against the JAX Denoiser on the same image."""
    jd, _ = denoisers
    rng = np.random.default_rng(0)
    clean = np.clip(0.5 + 0.2 * rng.standard_normal((16, 16)), 0, 1)
    noisy = np.clip(clean + (25 / 255) * rng.standard_normal((16, 16)), 0, 1).astype(np.float32)
    out = _post(server, "/v1/denoise_image", noisy, sigma=25)
    assert out.shape == (16, 16) and out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(jd.denoise_image(noisy, sigma=25)), atol=TOL)
    blind = _post(server, "/v1/denoise_image", noisy)
    np.testing.assert_allclose(blind, np.asarray(jd.denoise_image(noisy)), atol=TOL)
    assert np.abs(blind - out).max() > 0  # the estimate is not 25


def test_denoise_image_batched_matches_jax(server, denoisers):
    x = np.random.default_rng(1).uniform(size=(2, 1, 16, 16)).astype(np.float32)
    out = _post(server, "/v1/denoise_image", x, sigma=20)
    assert out.shape == (2, 1, 16, 16)
    np.testing.assert_allclose(out, np.asarray(denoisers[0].denoise_image(x, sigma=20)),
                               atol=TOL)


def test_bad_requests(server):
    code, body = _post_error(server, "/v1/denoise_image", b"junk", sigma=25)
    assert code == 400 and "error" in body
    code, _ = _post_error(server, "/v1/denoise_image",
                          _dump_npy(np.zeros((2, 1, 1, 16, 16), np.float32)), sigma=25)
    assert code == 400  # wrong rank
    code, _ = _post_error(server, "/v1/denoise_image",
                          _dump_npy(np.zeros((16, 16), np.float32)), sigma="x")
    assert code == 400  # bad query value
    code, _ = _post_error(server, "/v1/nope", _dump_npy(np.zeros((4, 4), np.float32)))
    assert code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/nope")
    assert e.value.code == 404


def test_denoise_video_endpoint_matches_jax():
    jd, d = _pair(JaxCDLNetVideo, CDLNetVideo, VIDEO_CFG)
    srv = DenoiseServer(d, port=0).start()
    try:
        clip = np.random.default_rng(2).uniform(size=(8, 16, 16)).astype(np.float32)
        out = _post(srv, "/v1/denoise_video", clip, sigma=25)
        assert out.shape == (8, 16, 16)
        np.testing.assert_allclose(out, np.asarray(jd.denoise_video(clip, sigma=25)), atol=TOL)
        # the streamed long-clip path (overlapping chunks)
        clip16 = np.random.default_rng(3).uniform(size=(16, 16, 16)).astype(np.float32)
        out = _post(srv, "/v1/denoise_video", clip16, sigma=25, chunk_depth=8, overlap=2)
        assert out.shape == (16, 16, 16)
        np.testing.assert_allclose(
            out, np.asarray(jd.denoise_video(clip16, sigma=25, chunk_depth=8, overlap=2)),
            atol=TOL)
        # chunking constraint violations surface as 400s, not 500s
        code, _ = _post_error(srv, "/v1/denoise_video", _dump_npy(clip16), sigma=25,
                              chunk_depth=8, overlap=4)
        assert code == 400
    finally:
        srv.stop()


def test_denoise_image_batch_per_sample_sigma_matches_single(server):
    d = server.denoiser
    rng = np.random.default_rng(5)
    imgs = rng.uniform(size=(3, 1, 16, 16)).astype(np.float32)
    sigmas = [15.0, 25.0, 35.0]
    batched = d.denoise_image_batch(imgs, sigmas)
    for i, s in enumerate(sigmas):
        np.testing.assert_allclose(batched[i], d.denoise_image(imgs[i], sigma=s), atol=TOL)
    flat = d.denoise_image_batch([imgs[0, 0], imgs[1, 0]], [15.0, 25.0])
    assert flat.shape == (2, 16, 16)
    np.testing.assert_allclose(flat[0], batched[0, 0], atol=TOL)
    with pytest.raises(ValueError):
        d.denoise_image_batch(imgs, [15.0, 25.0])  # wrong sigma count


def _concurrent(fn, n):
    """fn(i) for i < n on n threads at once; returns the results."""
    outs, errs = [None] * n, []
    barrier = threading.Barrier(n)

    def call(i):
        try:
            barrier.wait(timeout=60)
            outs[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errs, errs
    return outs


@pytest.mark.parametrize("blind", [False, True], ids=["known", "blind"])
def test_concurrent_requests_coalesce_correctly(server, denoisers, blind):
    """Concurrent single-image requests (known sigma, each its own; or
    blind, each image its own estimate) return each caller its result: the
    port's single-image call and JAX's, however the coalescer grouped
    them."""
    jd, d = denoisers
    rng = np.random.default_rng(6 + blind)
    imgs = [rng.uniform(size=(16, 16)).astype(np.float32) for _ in range(6)]
    sigmas = [None] * 6 if blind else [10.0, 15.0, 20.0, 25.0, 30.0, 35.0]
    before = dict(server.metrics.snapshot()["coalesced_batch_sizes"])
    outs = _concurrent(lambda i: _post(server, "/v1/denoise_image", imgs[i],
                                       **({} if blind else {"sigma": sigmas[i]})), 6)
    for img, s, out in zip(imgs, sigmas, outs):
        np.testing.assert_allclose(out, d.denoise_image(img, sigma=s), atol=TOL)
        np.testing.assert_allclose(out, np.asarray(jd.denoise_image(img, sigma=s)), atol=TOL)
    after = server.metrics.snapshot()["coalesced_batch_sizes"]
    served = sum(int(k) * (v - before.get(k, 0)) for k, v in after.items())
    assert served == 6


def test_coalescer_mixed_shapes_no_deadlock(server):
    """Different-shape concurrent requests fall into separate batches; the
    re-queued leftovers are still served."""
    rng = np.random.default_rng(7)
    shapes = [(16, 16), (16, 16), (32, 32), (16, 16), (32, 32)]
    imgs = [rng.uniform(size=s).astype(np.float32) for s in shapes]
    outs = _concurrent(lambda i: _post(server, "/v1/denoise_image", imgs[i], sigma=25),
                       len(shapes))
    for img, out in zip(imgs, outs):
        assert out.shape == img.shape
        np.testing.assert_allclose(out, server.denoiser.denoise_image(img, sigma=25), atol=TOL)


def test_metrics_endpoint(server):
    x = np.random.default_rng(8).uniform(size=(16, 16)).astype(np.float32)
    _post(server, "/v1/denoise_image", x, sigma=25)
    status, body = _get(server, "/metrics")
    m = json.loads(body)
    assert status == 200
    assert m["requests"].get("/v1/denoise_image", 0) >= 1
    lat = m["latency_s"]["/v1/denoise_image"]
    assert lat["count"] >= 1 and lat["mean"] > 0 and lat["max"] >= lat["mean"]
    # the coalescer records every dispatch's batch size
    assert sum(int(v) for v in m["coalesced_batch_sizes"].values()) >= 1


def test_npy_helpers_reject_pickle():
    # object arrays require pickle; the parser must refuse, not execute
    buf = io.BytesIO()
    np.save(buf, np.array([{"a": 1}], dtype=object), allow_pickle=True)
    with pytest.raises(server_mod._BadRequest):
        _parse_npy(buf.getvalue())
    assert _parse_npy(_dump_npy(np.arange(4, dtype=np.uint8))).dtype == np.float32


class _ProbeDenoiser:
    """A Denoiser stand-in that records how many calls run at once, or
    raises."""

    def __init__(self, fail=None):
        self.model = CDLNet(K=1, M=2, P=3)
        self.device = torch.device("cpu")
        self.blind, self.bucket, self.fail = "MAD", 16, fail
        self.active = self.most = 0
        self.batches = []
        self._count = threading.Lock()

    def _run(self, x):
        with self._count:
            self.active += 1
            self.most = max(self.most, self.active)
        time.sleep(0.02)
        with self._count:
            self.active -= 1
        if self.fail is not None:
            raise self.fail
        return x

    def denoise_image_batch(self, imgs, sigmas=None):
        self.batches.append(len(imgs))
        return self._run(imgs)

    def denoise_image(self, img, sigma=None):
        return self._run(img)

    def denoise_video(self, clip, sigma=None, **kw):
        return self._run(clip)


def test_device_lock_serializes_coalesced_and_video_requests():
    """Coalesced image batches (the coalescer's thread) and video and
    batch requests (handler threads) never run on the device at once."""
    probe = _ProbeDenoiser()
    srv = DenoiseServer(probe, port=0, max_batch=4).start()
    try:
        img = np.zeros((8, 8), np.float32)
        clip = np.zeros((4, 8, 8), np.float32)
        outs = _concurrent(
            lambda i: _post(srv, "/v1/denoise_video" if i % 3 == 0 else "/v1/denoise_image",
                            clip if i % 3 == 0 else (img if i % 3 == 1 else img[None, None]),
                            sigma=25), 12)
    finally:
        srv.stop()
    assert len(outs) == 12 and probe.most == 1 and max(probe.batches) <= 4


def test_max_batch_one_serves_without_a_coalescer(denoisers):
    srv = DenoiseServer(denoisers[1], port=0, max_batch=1).start()
    try:
        assert srv.coalescer is None
        x = np.random.default_rng(9).uniform(size=(16, 16)).astype(np.float32)
        np.testing.assert_allclose(_post(srv, "/v1/denoise_image", x, sigma=25),
                                   np.asarray(denoisers[0].denoise_image(x, sigma=25)),
                                   atol=TOL)
    finally:
        srv.stop()


@pytest.mark.parametrize("path", ["/v1/denoise_image", "/v1/denoise_video"])
def test_a_failed_forward_is_a_500(path):
    """A failure inside the Denoiser (a kernel's, say) reaches the client
    as a 500 with its message; the server goes on serving."""
    srv = DenoiseServer(_ProbeDenoiser(fail=RuntimeError("kernel launch failed")),
                        port=0).start()
    try:
        body = _dump_npy(np.zeros((4, 8, 8) if "video" in path else (8, 8), np.float32))
        for _ in range(2):
            code, err = _post_error(srv, path, body, sigma=25)
            assert code == 500 and "kernel launch failed" in err["error"]
        assert _get(srv, "/healthz")[0] == 200
    finally:
        srv.stop()


def test_main_without_a_card_raises(monkeypatch):
    """main() with no --device serves on the card; with none it raises
    before building a model, and does not serve on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(server_mod.DenoiseServer, "serve_forever",
                        lambda self: started.append(self))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        server_mod.main([os.path.join(EXAMPLES, "cdlnet-flagship-demo"), "--port", "0"])
    assert not started


def test_main_serves_on_the_cpu_when_asked(monkeypatch, capsys):
    started = []
    monkeypatch.setattr(server_mod.DenoiseServer, "serve_forever",
                        lambda self: (started.append(self), self.httpd.server_close()))
    server_mod.main([os.path.join(EXAMPLES, "cdlnet-demo"), "--port", "0", "--device", "cpu",
                     "--max-batch", "1"])
    (srv,) = started
    assert srv.denoiser.device.type == "cpu" and srv.coalescer is None
    assert "listening on http://127.0.0.1:" in capsys.readouterr().out
