"""HTTP serving daemon around serve.Denoiser (counterpart of
cdlnet_tpu/server.py: the same wire format, endpoints, status codes and
metrics).

Wire format is raw ``.npy`` bytes (``numpy.save``/``numpy.load``,
``allow_pickle`` disabled): lossless float arrays both ways. Shapes follow
serve.Denoiser: images (H, W), (C, H, W) or (N, C, H, W); videos (D, H, W),
(C, D, H, W) or (N, C, D, H, W); values in [0, 1].

Endpoints:
  GET  /healthz                     -> 200 "ok"
  GET  /info                        -> model/config/serving metadata (JSON)
  GET  /metrics                     -> request counts, latencies and the
                                       coalesced batch sizes (JSON)
  POST /v1/denoise_image?sigma=25   -> denoised .npy (sigma omitted = blind)
  POST /v1/denoise_video?sigma=25[&chunk_depth=16&overlap=4&tile_hw=256
                         &overlap_hw=16]
                                    -> denoised .npy (long clips stream in
                                       chunks; big frames tile)
A malformed request or an input the Denoiser rejects (a ValueError) is a
400, an unknown path a 404, any other failure, a kernel's included, a 500
with the error: nothing is retried on another backend.

Device work is serialized by one lock: a coalesced image batch (run by the
coalescer's thread) and a video or batch request (run by its handler
thread) hold it from the host-to-device copy until the card has finished
every kernel it queued (a device synchronize before the lock is released),
so two requests' kernels never overlap on the card; parsing and
serialization run on the HTTP thread pool outside it.

Run:  python -m cdlnet_tpu_torch.server examples/cdlnet-flagship-demo --port 8411
      (an args.json or a trained-model dir; on the card, or --device cpu)
"""

from __future__ import annotations

import io
import inspect
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

NPY_CONTENT_TYPE = "application/x-npy"
MAX_BODY_BYTES = 1 << 30  # 1 GiB of raw float input is plenty for one call


class _BadRequest(ValueError):
    pass


def _parse_npy(body: bytes) -> np.ndarray:
    try:
        arr = np.load(io.BytesIO(body), allow_pickle=False)
    except Exception as e:  # malformed .npy
        raise _BadRequest(f"body is not a valid .npy array: {e}") from e
    if arr.dtype.kind not in "fiu":
        raise _BadRequest(f"unsupported dtype {arr.dtype}; send float in [0,1]")
    return np.asarray(arr, np.float32)


def _dump_npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, np.float32))
    return buf.getvalue()


def _query_float(q, name, default=None):
    if name not in q:
        return default
    try:
        return float(q[name][0])
    except ValueError as e:
        raise _BadRequest(f"bad query param {name}={q[name][0]!r}") from e


def _query_int(q, name, default=None):
    v = _query_float(q, name, None)
    return default if v is None else int(v)


def model_config(model) -> dict:
    """The model's constructor arguments as JSON values (tuples as lists),
    as the JAX package's /info reports a model dataclass's fields."""
    names = [n for n in inspect.signature(type(model).__init__).parameters if n != "self"]
    return {n: (list(v) if isinstance(v, tuple) else v)
            for n in names if (v := getattr(model, n, None)) is not None}


class _Metrics:
    """Thread-safe serving counters, exposed at GET /metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = {}        # path -> count
        self.errors = {}          # path -> count
        self.latency_s = {}       # path -> [count, total, max]
        self.batch_sizes = {}     # size -> count (coalesced dispatches)

    def observe(self, path, seconds, error=False):
        with self._lock:
            self.requests[path] = self.requests.get(path, 0) + 1
            if error:
                self.errors[path] = self.errors.get(path, 0) + 1
            c = self.latency_s.setdefault(path, [0, 0.0, 0.0])
            c[0] += 1
            c[1] += seconds
            c[2] = max(c[2], seconds)

    def observe_batch(self, n):
        with self._lock:
            self.batch_sizes[n] = self.batch_sizes.get(n, 0) + 1

    def snapshot(self):
        with self._lock:
            return {
                "requests": dict(self.requests),
                "errors": dict(self.errors),
                "latency_s": {
                    p: {"count": c, "mean": (t / c if c else 0.0), "max": mx}
                    for p, (c, t, mx) in self.latency_s.items()
                },
                "coalesced_batch_sizes": {
                    str(k): v for k, v in sorted(self.batch_sizes.items())
                },
            }


def _on_device(denoiser, lock: threading.Lock, fn):
    """fn() under the device lock, released only once the card has run
    every kernel fn queued."""
    with lock:
        out = fn()
        if denoiser.device.type == "cuda":
            torch.cuda.synchronize(denoiser.device)
    return out


class _Coalescer:
    """Opportunistic cross-request batching for single-image calls.

    A lone request runs immediately (the worker drains only what is
    already queued: no idle wait, so batching adds no latency without
    concurrency); under concurrent load, same-shape requests with the
    same sigma mode (known or blind) coalesce into one
    Denoiser.denoise_image_batch forward of up to max_batch images. The
    rest of the queue goes back for the next rounds; an error is relayed
    to every caller of its batch."""

    def __init__(self, denoiser, lock: threading.Lock, max_batch: int = 8,
                 metrics=None):
        self.denoiser = denoiser
        self.lock = lock
        self.metrics = metrics
        self.max_batch = max(1, int(max_batch))
        self.q = queue.Queue()
        threading.Thread(target=self._loop, daemon=True).start()

    def denoise(self, img: np.ndarray, sigma):
        """Blocking single-image call; may be served from a shared batch."""
        ev = threading.Event()
        slot = {}
        self.q.put(((img.shape, sigma is None), img, sigma, ev, slot))
        if not ev.wait(timeout=600):
            raise TimeoutError("denoise batch worker timed out")
        if "err" in slot:
            raise slot["err"]
        return slot["out"]

    def _loop(self):
        while True:
            first = self.q.get()
            group, leftover = [first], []
            while len(group) < self.max_batch:
                try:
                    item = self.q.get_nowait()
                except queue.Empty:
                    break
                (group if item[0] == first[0] else leftover).append(item)
            for item in leftover:  # different shape/mode: next rounds
                self.q.put(item)
            if self.metrics is not None:
                self.metrics.observe_batch(len(group))
            try:
                imgs = np.stack([g[1] for g in group])
                sigmas = None if first[0][1] else [float(g[2]) for g in group]
                outs = _on_device(self.denoiser, self.lock,
                                  lambda: self.denoiser.denoise_image_batch(imgs, sigmas))
                for g, out in zip(group, outs):
                    g[4]["out"] = out
            except Exception as e:  # noqa: BLE001 — relayed to each caller
                for g in group:
                    g[4]["err"] = e
            finally:
                for g in group:
                    g[3].set()


def make_handler(denoiser, lock: threading.Lock, coalescer=None,
                 metrics=None):
    """Build the request-handler class closed over a Denoiser + device lock."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # quiet default request logging; errors still reach stderr
        def log_message(self, fmt, *args):  # noqa: D401
            pass

        def _send(self, code, body: bytes, ctype="application/json"):
            self._last_code = code
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code, obj):
            self._send(code, json.dumps(obj, default=str).encode())

        def do_GET(self):  # noqa: N802 (stdlib API)
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif path == "/info":
                m = denoiser.model
                self._send_json(200, {
                    "model": type(m).__name__,
                    "config": model_config(m),
                    "blind": denoiser.blind,
                    "bucket": denoiser.bucket,
                    "n_params": int(sum(p.numel() for p in m.parameters())),
                })
            elif path == "/metrics":
                self._send_json(
                    200, metrics.snapshot() if metrics is not None else {})
            else:
                self._send_json(404, {"error": f"no such path {path}"})

        def do_POST(self):  # noqa: N802
            t0 = time.monotonic()
            try:
                self._post_impl()
            finally:
                if metrics is not None:
                    metrics.observe(
                        urlparse(self.path).path, time.monotonic() - t0,
                        error=getattr(self, "_last_code", 500) >= 400,
                    )

        def _post_impl(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n <= 0:
                    raise _BadRequest("empty body; POST .npy bytes")
                if n > MAX_BODY_BYTES:
                    raise _BadRequest(f"body too large ({n} bytes)")
                arr = _parse_npy(self.rfile.read(n))
                sigma = _query_float(q, "sigma")
                if url.path == "/v1/denoise_image":
                    if arr.ndim not in (2, 3, 4):
                        raise _BadRequest(
                            f"image must be 2-4D, got shape {arr.shape}")
                    if coalescer is not None and arr.ndim in (2, 3):
                        # single images coalesce across concurrent requests
                        out = coalescer.denoise(arr, sigma)
                    else:
                        out = _on_device(denoiser, lock,
                                         lambda: denoiser.denoise_image(arr, sigma=sigma))
                elif url.path == "/v1/denoise_video":
                    if arr.ndim not in (3, 4, 5):
                        raise _BadRequest(
                            f"video must be 3-5D, got shape {arr.shape}")
                    kw = dict(
                        chunk_depth=_query_int(q, "chunk_depth"),
                        overlap=_query_int(q, "overlap", 4),
                    )
                    tile = _query_int(q, "tile_hw")
                    if tile is not None:
                        kw["tile_hw"] = tile
                        kw["overlap_hw"] = _query_int(q, "overlap_hw", 16)
                    out = _on_device(denoiser, lock,
                                     lambda: denoiser.denoise_video(arr, sigma=sigma, **kw))
                else:
                    self._send_json(404, {"error": f"no such path {url.path}"})
                    return
                self._send(200, _dump_npy(out), NPY_CONTENT_TYPE)
            except ValueError as e:
                # a malformed request (_BadRequest), or input-dependent
                # validation raised downstream (shape/chunking constraints
                # from serve/streaming): a client error
                self._send_json(400, {"error": str(e)})
            except Exception as e:  # surface, don't kill the worker thread
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class DenoiseServer:
    """Threaded HTTP server owning one Denoiser.

    >>> srv = DenoiseServer(Denoiser.from_dir("examples/cdlnet-flagship-demo"))
    >>> srv.start()            # returns immediately; srv.port is bound
    >>> ...
    >>> srv.stop()
    """

    def __init__(self, denoiser, host="127.0.0.1", port=8411, max_batch=8):
        self.denoiser = denoiser
        self._lock = threading.Lock()
        self.metrics = _Metrics()
        self.coalescer = (
            _Coalescer(denoiser, self._lock, max_batch, metrics=self.metrics)
            if max_batch and max_batch > 1 else None
        )
        self.httpd = ThreadingHTTPServer(
            (host, port),
            make_handler(denoiser, self._lock, self.coalescer, self.metrics),
        )
        self.httpd.daemon_threads = True
        self._thread = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def main(argv=None):
    """Serve a trained model: build the Denoiser on --device (the card by
    default: with no card it raises, it does not serve on the CPU), pre-run
    the --warmup shapes, and serve until interrupted."""
    import argparse
    import os

    from cdlnet_tpu_torch.serve import Denoiser
    from cdlnet_tpu_torch.utils import default_device

    p = argparse.ArgumentParser(
        description="Serve a trained cdlnet model over HTTP (.npy in/out)")
    p.add_argument("args", help="args.json path OR a trained-model directory")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8411)
    p.add_argument("--backend", default="pallas",
                   choices=["auto", "pallas", "cuda", "xla"])
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda: the card; cpu for the "
                        "kernels' plain versions on the CPU)")
    p.add_argument("--warmup", default=None,
                   help="comma-separated shapes to run once before serving, e.g. "
                        "'128x128,256x256' (images) or '16x128x128' (video)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="coalesce up to this many concurrent single-image "
                        "requests into one forward (1 disables)")
    a = p.parse_args(argv)

    # "cuda" goes through default_device's check: no card raises
    device = default_device(None if a.device == "cuda" else a.device)
    if os.path.isdir(a.args):
        d = Denoiser.from_dir(a.args, backend=a.backend, device=device)
    else:
        with open(a.args) as f:
            d = Denoiser.from_args(json.load(f), backend=a.backend, device=device)
    if a.warmup:
        shapes = [tuple(int(x) for x in s.split("x"))
                  for s in a.warmup.split(",")]
        d.warmup(shapes)
    srv = DenoiseServer(d, host=a.host, port=a.port, max_batch=a.max_batch)
    print(f"cdlnet-serve: listening on http://{a.host}:{srv.port} "
          f"(model={type(d.model).__name__}, device={d.device})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
