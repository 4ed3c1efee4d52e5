"""Small shared helpers (counterpart of cdlnet_tpu/utils.py without its
JAX compile cache): the device default, the debug and trace switches, the
metrics log, PSNR, and image, video and grid IO on numpy arrays. PIL is
imported where a file is read or written, and only there."""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    card. Without one it raises: the CPU is taken only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: cdlnet_tpu_torch runs on the card by default; "
            'pass device="cpu" to run on the CPU (the kernels\' plain versions)'
        )
    return torch.device("cuda")


def debug_nans() -> bool:
    """CDLNET_DEBUG_NANS is set (to anything but the empty string, as the
    JAX package reads it)."""
    return bool(os.environ.get("CDLNET_DEBUG_NANS"))


def setup_debug():
    """The debug switches (counterpart of cdlnet_tpu/utils.py::setup_debug,
    which the CLIs and the server call first):

    CDLNET_DEBUG_NANS=1   torch.autograd.set_detect_anomaly(True): a backward
                          op that makes a NaN raises there; and fit and
                          fit_csr check each step's loss (check_finite),
                          raising FloatingPointError on a NaN or Inf, as
                          jax_debug_nans stops at a forward NaN
    CDLNET_LOG_COMPILES=1 log each nvcc build of the kernels
                          (kernels/_build.py reads it at the build): source,
                          seconds and result; the port's only compilation
    """
    if debug_nans():
        torch.autograd.set_detect_anomaly(True)


def check_finite(loss: torch.Tensor, what: str):
    """Under CDLNET_DEBUG_NANS, raise FloatingPointError if `loss` holds a NaN
    or an Inf (a host read: it synchronizes); else nothing, and no sync."""
    if debug_nans() and not bool(torch.isfinite(loss).all()):
        raise FloatingPointError(f"CDLNET_DEBUG_NANS: non-finite loss {what}: "
                                 f"{loss.detach().flatten()[:8].tolist()}")


_NO_SPAN = contextlib.nullcontext()  # the span of every call made while no profiler runs
SPAN_CAP = 1 << 20  # records kept; later spans are counted in spans_dropped
_spans: list = []  # (name, start_ns, end_ns, parent, root); end_ns None while open
_spans_lock = threading.Lock()
_spans_epoch = 0  # bumped by clear_spans: an open span of an older list is not written back
_span_stack = threading.local()  # .open: this thread's open spans, [(epoch, index)]
spans_dropped = 0


class _Span:
    """A recorded span (trace_span): record_function's, and a record in
    _spans, its parent and root read off this thread's stack of open
    spans."""

    __slots__ = ("name", "rf", "at")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global spans_dropped
        stack = getattr(_span_stack, "open", None)
        if stack is None:
            stack = _span_stack.open = []
        with _spans_lock:
            epoch = _spans_epoch
            if len(_spans) >= SPAN_CAP:
                spans_dropped += 1
                self.at = (epoch, -1)
            else:
                index = len(_spans)
                up_epoch, parent = stack[-1] if stack else (epoch, -1)
                if up_epoch != epoch or parent < 0:
                    parent = -1
                root = _spans[parent][4] if parent >= 0 else index
                self.at = (epoch, index)
                _spans.append((self.name, time.time_ns(), None, parent, root))
        stack.append(self.at)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        end = time.time_ns()
        _span_stack.open.pop()
        epoch, index = self.at
        if index >= 0:
            with _spans_lock:
                if epoch == _spans_epoch:
                    name, start, _, parent, root = _spans[index]
                    _spans[index] = (name, start, end, parent, root)
        return False


def trace_span(name: str):
    """A named span of the program (the JAX package's
    jax.profiler.TraceAnnotation), recorded only while a torch.profiler
    session runs: maybe_start_trace's, or any caller's, a CUDA-only one
    too. torch.autograd.profiler._is_profiler_enabled says so: the
    profiler sets it at its start in every activity mode, and it holds in
    every thread of the process, where torch._C._autograd._profiler_enabled()
    holds only in the thread that started the session (checked on the H100
    under profile(activities=[CUDA])).

    With no session it returns one shared context that does nothing. Under
    one the span enters torch.profiler.record_function(name), so it shows
    in the profiler's trace beside the kernels, and appends a record
    (name, start_ns, end_ns, parent, root) that recorded_spans() returns:
    times from time.time_ns() around record_function's own entry and exit,
    the clock of the profiler's host events (its card events keep to that
    clock when the session records CPU activity too; in a CUDA-only one
    they strayed by up to 17 ms on the H100); parent the index of the span open around it on the same thread (-1:
    none), root the index of the outermost one, so the spans of one request
    or epoch share it. Past SPAN_CAP records spans are counted in
    spans_dropped and not kept."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def recorded_spans() -> list:
    """The spans recorded since clear_spans (or the process's start), in
    the order they opened: (name, start_ns, end_ns, parent, root) each,
    end_ns None for a span still open."""
    with _spans_lock:
        return list(_spans)


def clear_spans() -> None:
    """Forget the recorded spans and the count of dropped ones."""
    global _spans_epoch, spans_dropped
    with _spans_lock:
        _spans.clear()
        _spans_epoch += 1
        spans_dropped = 0


_trace = None  # the running trace: (profiler, directory, on the card)


def maybe_start_trace(device=None) -> bool:
    """Start a torch.profiler trace for $CDLNET_PROFILE_DIR, if it is set:
    the directory is made, and the trace records CPU activity, and the
    card's (CUDA) too where `device` is a CUDA device (None: where there is
    a card). Returns True; without the variable it returns False and does
    nothing. stop_trace ends it."""
    global _trace
    d = os.environ.get("CDLNET_PROFILE_DIR")
    if not d:
        return False
    os.makedirs(d, exist_ok=True)
    clear_spans()
    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _trace = (prof, d, on_card)
    return True


def stop_trace() -> str:
    """Stop the trace maybe_start_trace started (after the card's queued
    work has run) and write it as a Chrome trace (chrome://tracing,
    Perfetto) into its directory. Returns the file's path; raises
    RuntimeError when no trace runs, as jax.profiler.stop_trace does."""
    global _trace
    if _trace is None:
        raise RuntimeError("stop_trace: no trace is running")
    prof, d, on_card = _trace
    _trace = None
    if on_card:
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(d, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def append_metric(save_dir: str, **kv):
    """Append one JSON object to {save_dir}/metrics.jsonl — the structured
    mirror of the txt logs ({phase}.txt, backtrack.txt), which stay
    byte-compatible with the reference's."""
    with open(os.path.join(save_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps({"ts": round(time.time(), 3), **kv}) + "\n")


def psnr(a, b, data_range: float = 1.0) -> float:
    """-10 log10(MSE) in float64 (the reference protocol, analyze.py:104)."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse <= 0:
        return float("inf")
    return 10.0 * math.log10(data_range**2 / mse)


def img_load(path: str, gray: bool = False) -> np.ndarray:
    """Load an image file to (1, C, H, W) float32 in [0,1]."""
    from cdlnet_tpu_torch.data.images import _load_image

    return _load_image(path, load_color=not gray)[None]


def load_video(path: str, gray: bool = True) -> np.ndarray:
    """Load a directory of frames, in file-name order, to (1, C, D, H, W)
    float32 in [0,1]."""
    from cdlnet_tpu_torch.data.images import IMG_EXTS, _load_image

    files = [os.path.join(path, f) for f in sorted(os.listdir(path))
             if f.lower().endswith(IMG_EXTS)]
    frames = [_load_image(f, load_color=not gray) for f in files]
    return np.stack(frames, axis=1)[None]


def _to_uint8(a, clamp: bool) -> np.ndarray:
    a = np.asarray(a, np.float32)
    if clamp:
        a = np.clip(a, 0.0, 1.0)
    return (a * 255).round().astype(np.uint8)


def img_save(path: str, arr, clamp: bool = True):
    """Save a (C, H, W) or (1, C, H, W) [0,1] array as an image file."""
    from PIL import Image

    a = np.asarray(arr, np.float32)
    while a.ndim > 3:
        a = a[0]
    a = _to_uint8(a, clamp)
    if a.shape[0] == 1:
        Image.fromarray(a[0], mode="L").save(path)
    else:
        Image.fromarray(a.transpose(1, 2, 0), mode="RGB").save(path)


def save_gif(path: str, frames, fps: int = 8, clamp: bool = True):
    """Write a (D, H, W) or (C, D, H, W) [0,1] array as an animated GIF."""
    from PIL import Image

    a = np.asarray(frames, np.float32)
    if a.ndim == 4:  # (C, D, H, W) -> (D, H, W[, C])
        a = a.transpose(1, 2, 3, 0)
        if a.shape[-1] == 1:
            a = a[..., 0]
    a = _to_uint8(a, clamp)
    mode = "L" if a.ndim == 3 else "RGB"
    imgs = [Image.fromarray(f, mode=mode) for f in a]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)


def make_grid(filters, nrow: int, padding: int = 2, normalize_each: bool = False,
              value_range=None) -> np.ndarray:
    """Tile a (B, C, h, w) stack into one (C, H, W) grid image on a white
    background, nrow tiles a row; normalize_each maps each tile to [0, 1],
    else value_range=(lo, hi) clips to that range."""
    f = np.asarray(filters, np.float32)
    B, C, h, w = f.shape
    if normalize_each:
        mins = f.reshape(B, -1).min(1).reshape(B, 1, 1, 1)
        maxs = f.reshape(B, -1).max(1).reshape(B, 1, 1, 1)
        f = (f - mins) / np.maximum(maxs - mins, 1e-8)
    elif value_range is not None:
        lo, hi = value_range
        f = np.clip((f - lo) / max(hi - lo, 1e-8), 0, 1)
    rows = (B + nrow - 1) // nrow
    grid = np.ones((C, rows * (h + padding) + padding, nrow * (w + padding) + padding),
                   np.float32)
    for b in range(B):
        r, c = divmod(b, nrow)
        y, x = padding + r * (h + padding), padding + c * (w + padding)
        grid[:, y : y + h, x : x + w] = f[b]
    return grid
