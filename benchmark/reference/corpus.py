"""The training corpora's crop protocol, sample by sample.

Images: a crop x x x of an image at rows r0.., columns c0.., flipped
upside down where fv and left to right where fh. The draws give offsets in
the landscape frame that a portrait image is staged in (its transpose),
so a portrait image's crop starts at row ow, column oh.

Clips: `depth` frames of a video. With the random walk (walk), frames
start_w, start_w + 1, ... wrapping around the video, each cropped at its
own offset (x0, y0 plus the running sum of its steps, clamped to the
frame); otherwise the consecutive frames from start_c, reversed where rev,
cropped at (cy, cx) where do_crop, else the whole frames resized to the
crop size (bilinear with antialiasing).

check_* return a list of what breaks the protocol's ranges (empty when
the draws are sound).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def image_crop(img, crop: int, portrait: bool, oh: int, ow: int, fh: bool, fv: bool):
    """img: (C, H, W) as the benchmark made it."""
    r0, c0 = (ow, oh) if portrait else (oh, ow)
    out = img[:, r0:r0 + crop, c0:c0 + crop]
    if fv:
        out = out.flip(1)
    if fh:
        out = out.flip(2)
    return out


def check_image_draws(idx, oh, ow, sizes, crop: int) -> list:
    """sizes: the (H, W) of each image in its landscape frame."""
    bad = []
    for b, i in enumerate(idx):
        H, W = sizes[i]
        if not (0 <= oh[b] <= H - crop and 0 <= ow[b] <= W - crop):
            bad.append(f"image {i}: offset ({oh[b]}, {ow[b]}) outside {H}x{W}")
    return bad


def clip_frames(video, depth: int, crop_hw, max_shift: int, walk, start_w, x0, y0, steps,
                start_c, rev, do_crop, cx, cy):
    """video: (C, F, H, W). One sample's (C, depth, ch, cw) clip."""
    C, n, H, W = video.shape
    ch, cw = crop_hw
    frames = []
    if walk:
        xs = (x0 + torch.cumsum(steps[0], 0)).clamp(0, W - cw).tolist()
        ys = (y0 + torch.cumsum(steps[1], 0)).clamp(0, H - ch).tolist()
        for t in range(depth):
            f = (start_w + t) % n
            frames.append(video[:, f, ys[t]:ys[t] + ch, xs[t]:xs[t] + cw])
        return torch.stack(frames, 1)
    order = [start_c + (depth - 1 - t if rev else t) for t in range(depth)]
    if do_crop:
        return torch.stack([video[:, f, cy:cy + ch, cx:cx + cw] for f in order], 1)
    whole = video[:, order].transpose(0, 1)  # (depth, C, H, W)
    out = F.interpolate(whole, size=(ch, cw), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.transpose(0, 1)


def check_clip_draws(n: int, depth: int, frame_hw, crop_hw, max_shift: int, walk, start_w,
                     x0, y0, steps, start_c, rev, do_crop, cx, cy) -> list:
    H, W = frame_hw
    ch, cw = crop_hw
    bad = []
    if walk:
        if not (0 <= start_w < n and 0 <= x0 <= W - cw and 0 <= y0 <= H - ch):
            bad.append(f"walk start {start_w} at ({y0}, {x0})")
        if steps.abs().max() > max_shift:
            bad.append(f"walk step {int(steps.abs().max())} > {max_shift}")
    elif not 0 <= start_c <= n - depth:
        bad.append(f"window start {start_c} of {n} frames")
    elif do_crop and not (0 <= cx <= W - cw and 0 <= cy <= H - ch):
        bad.append(f"crop at ({cy}, {cx})")
    return bad
