"""Inference wrapper: load once, denoise numpy clips (counterpart of
cdlnet_tpu/serve.py, the video path).

Denoiser reflect-pads each clip's H and W up to multiples of `bucket`, runs
the model once under torch.inference_mode(), and crops back. Reflect
padding gives the denoiser better context at the borders than the zero
padding inside the convs, so bucketed outputs can differ slightly from the
unpadded forward near edges. The depth axis is not bucketed.

A failed kernel raises: there is no fallback to the plain path.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from cdlnet_tpu_torch.compat.jax_params import load_jax_params
from cdlnet_tpu_torch.models.base import build_model
from cdlnet_tpu_torch.train.checkpoint import load_params
from cdlnet_tpu_torch.utils import default_device

_NOT_PORTED = "is not ported to cdlnet_tpu_torch yet (see ROADMAP.md)"


def _bucket(n: int, b: int) -> int:
    return -(-n // b) * b


class Denoiser:
    """Serving wrapper around a model whose parameters are loaded.

    >>> d = Denoiser.from_dir("examples/cdlnet-video-demo")  # on the card
    >>> out = d.denoise_video(frames, sigma=25)            # (D, H, W)
    >>> out = d.denoise_video(clips, sigma=[15, 25])       # per-sample sigma
    """

    def __init__(self, model, bucket: int = 64, mesh=None):
        if mesh is not None:
            raise NotImplementedError(f"mesh serving {_NOT_PORTED}")
        self.model = model.eval()
        self.bucket = bucket
        self.device = next(model.parameters()).device

    @classmethod
    def from_args(cls, args: dict, backend: str = "pallas", device=None, **kw):
        """Build from a reference-schema args dict, on `device`: the card
        when None (no card raises; pass device="cpu" for the CPU). With
        paths.ckpt the parameters load from that .npz bundle; without it
        they come from the model's init (power method when model.init is
        true), seed 0."""
        model_args = dict(args["model"], backend=backend)
        want_init = model_args.pop("init", True)
        model = build_model(args["type"], model_args).to(default_device(device))
        ckpt = (args.get("paths") or {}).get("ckpt")
        if ckpt is None:
            model.init(torch.Generator().manual_seed(0), init=want_init)
        else:
            params, _ = load_params(ckpt)
            load_jax_params(model, params)
        return cls(model, **kw)

    @classmethod
    def from_dir(cls, path: str, **kw):
        """Build from a trained-model directory holding an args.json (e.g.
        examples/cdlnet-video-demo). The checkpoint path inside args.json is
        re-anchored to the directory when its recorded (train-time) path
        does not exist, so committed model dirs serve anywhere."""
        with open(os.path.join(path, "args.json")) as f:
            args = json.load(f)
        ck = (args.get("paths") or {}).get("ckpt")
        if ck and not os.path.exists(ck):
            local = os.path.join(path, os.path.basename(ck))
            if os.path.exists(local):
                args["paths"]["ckpt"] = local
        return cls.from_args(args, **kw)

    def _run(self, y: np.ndarray, sigma):
        """y: (N, C, D, H, W) float32 in [0,1]; pads H/W up to buckets."""
        spatial = y.shape[-2:]
        pads = [(_bucket(n, self.bucket) - n) for n in spatial]
        if any(pads):
            y = np.pad(y, [(0, 0)] * (y.ndim - 2) + [(0, p) for p in pads],
                       mode="reflect")
        if sigma is None and self.model.adaptive:
            raise NotImplementedError(f"blind sigma estimation {_NOT_PORTED}")
        if np.ndim(sigma) > 0:
            # per-sample sigmas in ONE forward
            sigma = np.asarray(sigma, np.float32).reshape(-1)
            if sigma.shape[0] != y.shape[0]:
                raise ValueError(f"{sigma.shape[0]} sigmas for {y.shape[0]} inputs")
            sigma = torch.from_numpy(sigma)
        elif sigma is not None:
            sigma = float(sigma)
        yt = torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(self.device)
        with torch.inference_mode():
            out = self.model(yt, sigma, return_z=False)[0]
        out = out.cpu().numpy()
        return out[..., : spatial[0], : spatial[1]]

    def denoise_video(self, clip: np.ndarray, sigma=None, chunk_depth=None,
                      tile_hw=None) -> np.ndarray:
        """clip: (D, H, W), (C, D, H, W) or (N, C, D, H, W) in [0,1]; sigma:
        a scalar or one per sample. Streaming long clips (chunk_depth) and
        spatial tiling (tile_hw) are not ported yet."""
        clip = np.asarray(clip, np.float32)
        if tile_hw is not None:
            raise NotImplementedError(f"tile_hw {_NOT_PORTED}")
        if chunk_depth is not None and clip.shape[-3] > chunk_depth:
            raise NotImplementedError(f"chunk_depth streaming {_NOT_PORTED}")
        squeeze = 5 - clip.ndim
        for _ in range(squeeze):
            clip = clip[None]
        out = self._run(clip, sigma)
        for _ in range(squeeze):
            out = out[0]
        return out
