"""Small shared helpers (counterpart of cdlnet_tpu/utils.py without its
JAX compile-cache and profiler switches): the device default, the metrics
log, PSNR, and image, video and grid IO on numpy arrays. PIL is imported
where a file is read or written, and only there."""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch


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
