"""Streaming inference for long and large videos (counterpart of
cdlnet_tpu/models/streaming.py).

A long clip streams through fixed device memory by overlap-discard
temporal chunking: chunks of `chunk_depth` frames overlap by `overlap` on
each side, and only each chunk's interior frames are kept, so every
emitted frame has at least `overlap` frames of context on both sides (the
clip's own first and last frames excepted). Big frames split the same way
into spatial tiles of `tile_hw` with `overlap_hw` pixels of context. The
chunk and tile arithmetic is the JAX package's, so the kept frames and
pixels are the same.

The LISTA iteration couples frames and pixels through the convolutions'
receptive field, so a chunked result is not the whole-clip forward: the
coupling decays geometrically with distance (the JAX package measured
~41 dB agreement at overlap 4 and ~52 dB at overlap_hw 16 on
spectral-init weights). Every chunk runs the model's own forward, on the
hand-written kernels for backend "pallas"/"cuda".
"""

from __future__ import annotations

import numpy as np
import torch

# chunks of denoise_long_video_pipelined queued on the card before the
# oldest is read back: one copied in, one in the forward, one copied out
MAX_IN_FLIGHT = 3


def _chunk_starts(D, chunk_depth, overlap):
    """Chunk start frames: every chunk_depth - 2*overlap frames, the last
    chunk clamped to end at D (it then overlaps its neighbour more)."""
    if chunk_depth <= 2 * overlap:
        raise ValueError(f"chunk_depth {chunk_depth} must exceed 2*overlap {2 * overlap}")
    step = chunk_depth - 2 * overlap
    return list(range(0, D - chunk_depth, step)) + [D - chunk_depth]


def _kept(starts, chunk_depth, overlap):
    """(t0, lo, hi) per chunk: frames [t0 + lo, t0 + hi) of the output come
    from frames [lo, hi) of the chunk starting at t0."""
    out, written = [], 0
    for t0 in starts:
        lo = 0 if t0 == 0 else max(written - t0, overlap)
        hi = chunk_depth if t0 == starts[-1] else chunk_depth - overlap
        out.append((t0, lo, hi))
        written = t0 + hi
    return out


def _forward(model, y, sigma, mask=None):
    return model(y, sigma, mask=mask, return_z=False)[0]


@torch.inference_mode()
def denoise_long_video(model, y, sigma=None, mask=None, chunk_depth=16, overlap=4):
    """Denoise a clip batch y (N, C, D, H, W), a tensor on the model's
    device, of any depth D in chunks of chunk_depth frames (a multiple of
    the model's stride). Returns xhat (N, C, D, H, W)."""
    D = y.shape[2]
    if D <= chunk_depth:
        return _forward(model, y, sigma, mask)
    out = torch.zeros_like(y)
    for t0, lo, hi in _kept(_chunk_starts(D, chunk_depth, overlap), chunk_depth, overlap):
        sl = slice(t0, t0 + chunk_depth)
        xc = _forward(model, y[:, :, sl], sigma, None if mask is None else mask[:, :, sl])
        out[:, :, t0 + lo : t0 + hi] = xc[:, :, lo:hi]
    return out


@torch.inference_mode()
def denoise_long_video_pipelined(model, clip, sigma=None, chunk_depth=16, overlap=4):
    """denoise_long_video for a host clip (N, C, D, H, W) numpy array that
    need not fit in device memory: chunk by chunk, the host-to-device copy,
    the forward and the copy back overlap, with at most MAX_IN_FLIGHT
    chunks outstanding. Returns a numpy array; the kept frames are
    denoise_long_video's, bit for bit.

    On the card each chunk moves through a pinned host buffer: the copies
    to and from the card run non_blocking on two side streams, so that the
    next chunk's copy in and the last chunk's copy out overlap this chunk's
    forward on the current stream, which waits only for its own input;
    a chunk's output is read back only when MAX_IN_FLIGHT later chunks
    have been queued. On the CPU it is the sequential loop."""
    clip = np.asarray(clip, np.float32)
    dev = next(model.parameters()).device
    D = clip.shape[2]
    if D <= chunk_depth:
        return _forward(model, torch.from_numpy(clip).to(dev), sigma).cpu().numpy()
    chunks = _kept(_chunk_starts(D, chunk_depth, overlap), chunk_depth, overlap)
    out = np.empty_like(clip)
    if dev.type != "cuda":
        for t0, lo, hi in chunks:
            xc = _forward(model, torch.from_numpy(clip[:, :, t0 : t0 + chunk_depth]), sigma)
            out[:, :, t0 + lo : t0 + hi] = xc[:, :, lo:hi].numpy()
        return out

    shape = clip[:, :, :chunk_depth].shape
    # one more slot than chunks in flight: a slot is reused only after the
    # chunk that held it was read back
    slots = MAX_IN_FLIGHT + 1
    host_in = [torch.empty(shape, pin_memory=True) for _ in range(slots)]
    host_out = [torch.empty(shape, pin_memory=True) for _ in range(slots)]
    compute = torch.cuda.current_stream(dev)
    h2d, d2h = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    inflight = []  # (t0, lo, hi, slot, event: the chunk's output is on the host)

    def drain_one():
        t0, lo, hi, slot, done = inflight.pop(0)
        done.synchronize()
        out[:, :, t0 + lo : t0 + hi] = host_out[slot][:, :, lo:hi].numpy()

    for i, (t0, lo, hi) in enumerate(chunks):
        slot = i % slots
        host_in[slot].copy_(torch.from_numpy(clip[:, :, t0 : t0 + chunk_depth]))
        with torch.cuda.stream(h2d):  # yd's memory comes from h2d's pool
            yd = torch.empty(shape, device=dev)
            yd.copy_(host_in[slot], non_blocking=True)
        compute.wait_stream(h2d)
        yd.record_stream(compute)  # h2d reuses it after the forward
        xd = _forward(model, yd, sigma)
        d2h.wait_stream(compute)
        with torch.cuda.stream(d2h):
            host_out[slot].copy_(xd, non_blocking=True)
        xd.record_stream(d2h)  # the compute stream reuses it after the copy
        done = torch.cuda.Event()
        done.record(d2h)
        inflight.append((t0, lo, hi, slot, done))
        if len(inflight) > MAX_IN_FLIGHT:
            drain_one()
    while inflight:
        drain_one()
    return out


def _tile_starts(n, tile, step):
    if n <= tile:
        return [0]
    return list(range(0, n - tile, step)) + [n - tile]


@torch.inference_mode()
def denoise_video_tiled(model, y, sigma=None, mask=None, chunk_depth=16, overlap=4,
                        tile_hw=None, overlap_hw=16):
    """Spatial overlap-discard tiling on top of the temporal streaming: the
    frames of y (N, C, D, H, W), a tensor on the model's device, split into
    tile_hw tiles (an int or (th, tw)) with overlap_hw pixels of context on
    each side, each tile streamed through denoise_long_video. tile_hw and
    overlap_hw should be multiples of the model's stride, and a tile side
    must exceed 2*overlap_hw. Returns xhat (N, C, D, H, W)."""
    H, W = y.shape[3:]
    if tile_hw is None:
        return denoise_long_video(model, y, sigma, mask=mask, chunk_depth=chunk_depth,
                                  overlap=overlap)
    th, tw = (tile_hw, tile_hw) if isinstance(tile_hw, int) else tile_hw
    th, tw = min(th, H), min(tw, W)
    if th <= 2 * overlap_hw and th < H or tw <= 2 * overlap_hw and tw < W:
        raise ValueError(f"tile_hw {(th, tw)} must exceed 2*overlap_hw {2 * overlap_hw}")

    out = torch.zeros_like(y)
    for i0 in _tile_starts(H, th, th - 2 * overlap_hw):
        ilo = 0 if i0 == 0 else overlap_hw
        ihi = th if i0 + th >= H else th - overlap_hw
        for j0 in _tile_starts(W, tw, tw - 2 * overlap_hw):
            win = (slice(None),) * 3 + (slice(i0, i0 + th), slice(j0, j0 + tw))
            xt = denoise_long_video(model, y[win], sigma,
                                    mask=None if mask is None else mask[win],
                                    chunk_depth=chunk_depth, overlap=overlap)
            jlo = 0 if j0 == 0 else overlap_hw
            jhi = tw if j0 + tw >= W else tw - overlap_hw
            out[:, :, :, i0 + ilo : i0 + ihi, j0 + jlo : j0 + jhi] = \
                xt[:, :, :, ilo:ihi, jlo:jhi]
    return out
