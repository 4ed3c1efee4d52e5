"""Inference wrapper: load once, denoise numpy images and clips
(counterpart of cdlnet_tpu/serve.py).

Denoiser reflect-pads each input's H and W up to multiples of `bucket`,
runs the model once under torch.inference_mode(), and crops back. Reflect
padding gives the denoiser better context at the borders than the zero
padding inside the convs, so bucketed outputs can differ slightly from the
unpadded forward near edges. The depth axis of clips is not bucketed.
Long clips stream through fixed device memory in overlapping chunks
(chunk_depth), and big frames split into overlapping tiles (tile_hw), by
models/streaming.py; a streamed clip is copied to the device whole when it
fits staging_limit(), a share of the free device memory, and otherwise
moves chunk by chunk through pinned host buffers.

Blind operation: sigma=None on an adaptive model estimates the noise level
per input with the Denoiser's `blind` estimator (nle.noise_level: "MAD",
the default, or "PCA") on the bucket-padded batch, on the device, as the
JAX package does: 255 * sigma_hat per image, and for clips the mean of the
framewise estimates per clip. (The JAX package's PCA estimates a batch's
first image only and fails on clips; here every image and frame gets its
own estimate.)

The frame-recurrent CSR models (models/csr.py) denoise a clip by their
recurrence (the model's video_denoise) with one sigma per call (blind:
models/csr.py::blind_sigma, the mean of the framewise estimates over every
clip of the call),
and an image as a frame with no neighbour code. They run whole clips only:
chunk_depth below the clip's depth and tile_hw raise, as they fail in the
JAX package's Denoiser.

DnCNN and FFDNet serve in eval() mode, on their checkpointed BatchNorm
running statistics (the JAX package's Denoiser drops them and serves on
mean 0 and variance 1). FFDNet takes sigma into its noise-level map; blind,
it takes the Denoiser's estimate there (JAX's passes none, a zero map).

A failed kernel raises: there is no fallback to the plain path.

Mesh serving (Denoiser(mesh=...), a dist.mesh.Mesh or its dict spec):
every rank calls a method with the same input and gets the whole output.
A "data" axis splits image batches and CSR video batches over the ranks; a
"depth" axis splits the frames of CDLNetVideo clips, on the kernels
through dist/halo_fused.py (residual blocks and backend "xla": the plain
halo route, dist/halo.py). Batches and clip depths that do not divide,
streamed and tiled clips run unsharded on every rank. Unlike the JAX
package's Denoiser, which demotes its plain path to "xla" under a mesh
because GSPMD cannot partition a Mosaic kernel, the port keeps the
kernels on every route.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from cdlnet_tpu_torch import nle
from cdlnet_tpu_torch.compat.jax_params import load_jax_params
from cdlnet_tpu_torch.models import streaming
from cdlnet_tpu_torch.models.base import build_model, resolve_backend
from cdlnet_tpu_torch.models.csr import CDLNetCSR, CDLNetCSRf2, blind_sigma
from cdlnet_tpu_torch.train.checkpoint import load_params
from cdlnet_tpu_torch.utils import default_device, trace_span

# share of the free device memory a streamed clip may take when staged
# whole (input and output together); the JAX package staged up to a fixed
# 2 GB on the TPU
STAGING_FRACTION = 0.25


def _bucket(n: int, b: int) -> int:
    return -(-n // b) * b


def _sigma_arg(sigma, device):
    """A per-sample sigma array as a tensor on the device; scalars and None
    as they are."""
    if sigma is None or np.ndim(sigma) == 0:
        return None if sigma is None else float(sigma)
    return torch.as_tensor(np.asarray(sigma, np.float32).reshape(-1), device=device)


class Denoiser:
    """Serving wrapper around a model whose parameters are loaded.

    >>> d = Denoiser.from_dir("examples/cdlnet-flagship-demo")  # on the card
    >>> out = d.denoise_image(img, sigma=25)               # (H, W) in [0,1]
    >>> out = d.denoise_image(img)                         # blind (MAD)
    >>> out = Denoiser(d.model, blind="PCA").denoise_image(img)  # blind (PCA)
    >>> out = d.denoise_image_batch(imgs, sigmas=[15, 25])  # per-image sigma
    >>> d = Denoiser.from_dir("examples/cdlnet-video-demo")
    >>> out = d.denoise_video(frames, sigma=25)            # (D, H, W)
    >>> out = d.denoise_video(long_clip, sigma=25, chunk_depth=16)  # streamed
    >>> out = d.denoise_video(clip, sigma=25, tile_hw=256)  # 256^2 tiles
    >>> d = Denoiser.from_dir("examples/csr-demo")         # frame-recurrent
    >>> out = d.denoise_video(volume, sigma=25)            # (D, H, W)
    """

    def __init__(self, model, bucket: int = 64, blind: str = "MAD", mesh=None):
        self.model = model.eval()
        self.bucket = bucket
        self.blind = blind
        self.device = next(model.parameters()).device
        # a CSR model denoises clips by its frame recurrence
        self._recurrent = isinstance(model, (CDLNetCSR, CDLNetCSRf2))
        self.mesh = None
        if mesh is not None:
            from cdlnet_tpu_torch.dist.mesh import as_mesh
            from cdlnet_tpu_torch.dist.sharding import replicate_sharding

            self.mesh = as_mesh(mesh)
            replicate_sharding(model)

    @classmethod
    def from_args(cls, args: dict, backend: str = "pallas", device=None, **kw):
        """Build from a reference-schema args dict, on `device`: the card
        when None (no card raises; pass device="cpu" for the CPU). With
        paths.ckpt the parameters (and a BatchNorm family's running
        statistics) load from that .npz bundle or reference torch .ckpt;
        without it they come from the model's init (power method when
        model.init is true), seed 0. `backend` goes to the families that
        have one (models.base.resolve_backend)."""
        model_args = dict(args["model"])
        backend = resolve_backend(args["type"], backend)
        if backend is not None:
            model_args["backend"] = backend
        want_init = model_args.pop("init", True)
        model = build_model(args["type"], model_args).to(default_device(device))
        ckpt = (args.get("paths") or {}).get("ckpt")
        if ckpt is None:
            model.init(torch.Generator().manual_seed(0), init=want_init)
        else:
            params, _ = load_params(ckpt, model)
            load_jax_params(model, params)
        return cls(model, **kw)

    @classmethod
    def from_dir(cls, path: str, **kw):
        """Build from a trained-model directory holding an args.json (e.g.
        examples/cdlnet-flagship-demo). The checkpoint path inside args.json
        is re-anchored to the directory when its recorded (train-time) path
        does not exist, so committed model dirs serve anywhere."""
        with open(os.path.join(path, "args.json")) as f:
            args = json.load(f)
        ck = (args.get("paths") or {}).get("ckpt")
        if ck and not os.path.exists(ck):
            local = os.path.join(path, os.path.basename(ck))
            if os.path.exists(local):
                args["paths"]["ckpt"] = local
        return cls.from_args(args, **kw)

    def _blind_sigma(self, y: torch.Tensor) -> torch.Tensor:
        """255 * the blind estimate per image (N,), or per clip the mean of
        its framewise estimates."""
        if y.ndim == 5:
            N, C, D, H, W = y.shape
            frames = y.transpose(1, 2).reshape(N * D, C, H, W)
            s = nle.noise_level(frames, method=self.blind).reshape(N, D).mean(dim=1)
        else:
            s = nle.noise_level(y, method=self.blind).reshape(-1)
        return 255.0 * s

    def _run(self, y: np.ndarray, sigma):
        """y: (N, C, [D,] H, W) float32 in [0,1]; pads H/W up to buckets.
        Its spans, in order: serve_input (pad, copy to the device),
        serve_sigma (the blind estimate, when taken), serve_forward (the
        model), serve_fetch (the wait for the device and the copy back),
        serve_output (the numpy view and the crop)."""
        with trace_span("serve_input"):
            spatial = y.shape[-2:]
            pads = [(_bucket(n, self.bucket) - n) for n in spatial]
            if any(pads):
                y = np.pad(y, [(0, 0)] * (y.ndim - 2) + [(0, p) for p in pads],
                           mode="reflect")
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
            recurrent_clip = self._recurrent and yt.ndim == 5
            if sigma is None and self.model.adaptive:
                with trace_span("serve_sigma"):
                    sigma = (blind_sigma(yt, self.blind) if recurrent_clip
                             else self._blind_sigma(yt))
            with trace_span("serve_forward"):
                if self.mesh is not None:
                    out = self._mesh_forward(yt, sigma)
                elif not self._recurrent:
                    out = self.model(yt, sigma, return_z=False)[0]
                elif recurrent_clip:
                    out = self.model.video_denoise(yt, sigma)[0]
                else:  # a frame with no neighbour code
                    out = self.model(yt, sigma=sigma)[0]
        with trace_span("serve_fetch"):
            out = out.cpu()
        with trace_span("serve_output"):
            return out.numpy()[..., : spatial[0], : spatial[1]]

    def _forward(self, y, sigma):
        """The model's output for y on this rank alone."""
        if not self._recurrent:
            return self.model(y, sigma, return_z=False)[0]
        if y.ndim == 5:
            return self.model.video_denoise(y, sigma)[0]
        return self.model(y, sigma=sigma)[0]

    def _mesh_forward(self, y, sigma):
        """The forward over the mesh (module docstring), whole on every
        rank."""
        from cdlnet_tpu_torch.dist.halo_fused import depth_sharded_forward
        from cdlnet_tpu_torch.dist.sharding import shard_map_forward

        mesh, N = self.mesh, y.shape[0]
        ndata, ndepth = mesh.size("data"), mesh.size("depth")
        spec = None
        if isinstance(sigma, torch.Tensor) and sigma.ndim == 1:
            # one sigma a sample, split with the batch: the recurrence takes
            # it as (N,), the other families as (N, 1, ...)
            sigma = sigma.to(y.device)
            if self._recurrent:
                spec = "shard"
            else:
                sigma = sigma.reshape(-1, *([1] * (y.ndim - 1)))
        batch_axis = "data" if "data" in mesh.shape and N % ndata == 0 else None
        s = getattr(self.model, "s", 1)
        if (ndepth > 1 and y.ndim == 5 and not self._recurrent and hasattr(self.model, "pad")
                and y.shape[2] % (ndepth * s) == 0):
            return depth_sharded_forward(self.model, y, sigma, mesh=mesh, batch_axis=batch_axis)
        if batch_axis is None:
            return self._forward(y, sigma)
        smf = shard_map_forward(mesh, lambda p, yl, sl, ml: self._forward(yl, sl),
                                sigma_spec=spec)
        return smf({}, y, sigma)

    def denoise_image(self, img: np.ndarray, sigma=None) -> np.ndarray:
        """img: (H, W), (C, H, W) or (N, C, H, W) in [0,1]; sigma: a scalar,
        one per image, or None (blind on adaptive models)."""
        with trace_span("serve_request"):
            img = np.asarray(img, np.float32)
            squeeze = 4 - img.ndim
            for _ in range(squeeze):
                img = img[None]
            out = self._run(img, sigma)
            for _ in range(squeeze):
                out = out[0]
            return out

    def denoise_image_batch(self, imgs, sigmas=None) -> np.ndarray:
        """One forward over a stack of same-shape images with per-image
        noise levels.

        imgs: (N, C, H, W) array or a sequence of same-shape (H, W) /
        (C, H, W) images; sigmas: None (all blind), a scalar, or a length-N
        sequence. Returns the denoised stack with the input's per-image
        layout."""
        with trace_span("serve_request"):
            if not isinstance(imgs, np.ndarray):
                imgs = np.stack([np.asarray(im, np.float32) for im in imgs])
            imgs = np.asarray(imgs, np.float32)
            squeeze = 4 - imgs.ndim  # (N, H, W) stacks need a channel dim
            for _ in range(squeeze):
                imgs = imgs[:, None]
            if sigmas is not None and np.ndim(sigmas) > 0 and len(sigmas) != imgs.shape[0]:
                raise ValueError(f"{len(sigmas)} sigmas for {imgs.shape[0]} images")
            out = self._run(imgs, sigmas)
            for _ in range(squeeze):
                out = out[:, 0]
            return out

    def _clip_sigma(self, clip: np.ndarray, sigma, chunk_depth: int):
        """sigma as given, or on an adaptive model with sigma None the blind
        estimate per clip (the mean of its framewise estimates, as
        _run computes it), taken over chunk_depth frames at a time so that
        a clip larger than device memory can be estimated."""
        if sigma is not None or not self.model.adaptive:
            return sigma
        N, C, D, H, W = clip.shape
        total = torch.zeros(N, device=self.device)
        with torch.inference_mode():
            for t0 in range(0, D, chunk_depth):
                part = clip[:, :, t0 : t0 + chunk_depth]
                frames = torch.from_numpy(np.ascontiguousarray(
                    part.transpose(0, 2, 1, 3, 4).reshape(-1, C, H, W))).to(self.device)
                s = nle.noise_level(frames, method=self.blind).reshape(N, -1)
                total += s.sum(dim=1)
        return (255.0 * total / D).cpu().numpy()

    def staging_limit(self) -> int:
        """Bytes of a streamed clip that denoise_video copies to the device
        whole: STAGING_FRACTION of the free device memory, shared by the
        staged input and output clips (the rest is left to the chunk
        forward's codes, ~0.62 GB per 16x480x896 chunk at M=169). No limit
        on the CPU."""
        if self.device.type != "cuda":
            return sys.maxsize
        free, _ = torch.cuda.mem_get_info(self.device)
        return int(STAGING_FRACTION * free) // 2

    def denoise_video(self, clip: np.ndarray, sigma=None, chunk_depth=None, overlap=4,
                      tile_hw=None, overlap_hw=16) -> np.ndarray:
        """clip: (D, H, W), (C, D, H, W) or (N, C, D, H, W) in [0,1]; sigma:
        a scalar, one per sample, or None (blind on adaptive models).

        With chunk_depth set and a deeper clip, the clip streams in chunks
        of chunk_depth frames overlapping by `overlap` (models/streaming.py)
        after the bucket pad: copied to the device whole when input and
        output fit staging_limit(), else through the pipelined host loop.
        With tile_hw set (an int or (th, tw)) the frames also split into
        tiles with overlap_hw pixels of context, without the bucket pad.
        Blind sigma is estimated once per clip, over all its frames."""
        with trace_span("serve_request"):
            clip = np.asarray(clip, np.float32)
            squeeze = 5 - clip.ndim
            for _ in range(squeeze):
                clip = clip[None]
            D = clip.shape[2]
            if self._recurrent and (tile_hw is not None
                                    or (chunk_depth is not None and D > chunk_depth)):
                raise TypeError(
                    f"{type(self.model).__name__} runs whole clips by its frame recurrence: "
                    "chunk_depth below the clip's depth and tile_hw stream a clip "
                    "denoiser, as in the JAX package's Denoiser, where they fail too")
            if tile_hw is not None:
                depth = chunk_depth or D
                sig = self._clip_sigma(clip, sigma, depth)
                y = torch.from_numpy(clip).to(self.device)
                out = streaming.denoise_video_tiled(
                    self.model, y, _sigma_arg(sig, self.device), chunk_depth=depth,
                    overlap=overlap, tile_hw=tile_hw, overlap_hw=overlap_hw).cpu().numpy()
            elif chunk_depth is not None and D > chunk_depth:
                spatial = clip.shape[3:]
                pads = [(_bucket(n, self.bucket) - n) for n in spatial]
                if any(pads):
                    clip = np.pad(clip, [(0, 0)] * 3 + [(0, p) for p in pads], mode="reflect")
                sig = self._clip_sigma(clip, sigma, chunk_depth)
                if clip.nbytes <= self.staging_limit():
                    y = torch.from_numpy(clip).to(self.device)
                    out = streaming.denoise_long_video(
                        self.model, y, _sigma_arg(sig, self.device), chunk_depth=chunk_depth,
                        overlap=overlap).cpu().numpy()
                else:
                    out = streaming.denoise_long_video_pipelined(
                        self.model, clip, _sigma_arg(sig, self.device),
                        chunk_depth=chunk_depth, overlap=overlap)
                out = out[..., : spatial[0], : spatial[1]]
            else:
                out = self._run(clip, sigma)
            for _ in range(squeeze):
                out = out[0]
            return out

    def warmup(self, shapes):
        """Build the kernels and run each bucket once, for a list of (H, W)
        image or (D, H, W) clip shapes."""
        for shape in shapes:
            if len(shape) == 2:
                self.denoise_image(np.zeros(shape, np.float32), sigma=25)
            else:
                self.denoise_video(np.zeros(shape, np.float32), sigma=25)
