"""Video clip dataset and loaders (the port's own copy of
cdlnet_tpu/data/video.py: the same clips, crops and batches for a seed).

One sample is `depth` consecutive frames of a video directory, stacked to
(C, D, H, W) float32 in [0, 1]. Train augmentations (reference
data3d.py:46-141):
  - with probability `aug_prob`: a random-walk crop, a window that drifts
    up to `max_shift` px per frame, over a frame range that wraps around;
  - otherwise: a consecutive window, reversed in time with probability
    0.5, with one shared spatial crop with probability `crop_ratio`, else
    resized to the crop size.
Test: the first `depth` frames at full resolution. The train loader
assembles its batches in num_workers threads (data/loader.py).
"""

from __future__ import annotations

import os

import numpy as np

from cdlnet_tpu_torch.data.images import IMG_EXTS, _load_image
from cdlnet_tpu_torch.data.loader import DataLoader, ThreadSafeRng


def _resize(img: np.ndarray, size) -> np.ndarray:
    """Bilinear-resize a (C, H, W) [0,1] array to size=(W, H) via PIL."""
    from PIL import Image

    w, h = size
    chans = [
        np.asarray(
            Image.fromarray((c * 255).astype(np.uint8)).resize((w, h), Image.BILINEAR),
            np.float32,
        )
        / 255.0
        for c in img
    ]
    return np.stack(chans, axis=0)


class VideoClipDataset:
    def __init__(self, root_dirs, load_color=False, depth=16, image_size=(128, 128),
                 test=False, crop_ratio=0.5, aug_prob=0.3, max_shift=10, seed=0):
        self.video_dirs = []
        for cur in root_dirs:
            self.video_dirs += [
                os.path.join(cur, d)
                for d in sorted(os.listdir(cur))
                if os.path.isdir(os.path.join(cur, d))
            ]
        self.root_dirs = list(root_dirs)
        self.depth = depth
        self.load_color = load_color
        self.image_size = tuple(image_size)
        self.test = test
        self.crop_ratio = crop_ratio
        self.aug_prob = aug_prob
        self.max_shift = max_shift
        self.rng = ThreadSafeRng(seed)

    def __len__(self):
        return len(self.video_dirs)

    def _frame_files(self, vdir):
        return [os.path.join(vdir, f) for f in sorted(os.listdir(vdir))
                if f.lower().endswith(IMG_EXTS)]

    def _random_walk(self, files, rng):
        """A crop window drifting up to max_shift px per frame over a
        wrap-around run of frames."""
        n = len(files)
        start = int(rng.integers(0, n))
        sel = files[start : start + self.depth]
        if len(sel) < self.depth:
            sel += files[: self.depth - len(sel)]
        _, H, W = _load_image(sel[0], self.load_color).shape
        cw, ch = self.image_size
        if cw > W or ch > H:
            raise ValueError(f"crop {self.image_size} larger than frame {(W, H)}")
        x = int(rng.integers(0, W - cw + 1))
        y = int(rng.integers(0, H - ch + 1))
        frames = []
        shift = self.max_shift
        for f in sel:
            img = _load_image(f, self.load_color)
            x = min(max(x + int(rng.integers(-shift, shift + 1)), 0), W - cw)
            y = min(max(y + int(rng.integers(-shift, shift + 1)), 0), H - ch)
            frames.append(img[:, y : y + ch, x : x + cw])
        return frames

    def _window(self, files, rng):
        """Consecutive frames: the first `depth` in test mode; in train
        mode a random window, maybe reversed, with one shared crop or a
        resize to the crop size."""
        n = len(files)
        start = 0 if self.test else int(rng.integers(0, n - self.depth + 1))
        sel = files[start : start + self.depth]
        if not self.test and rng.random() < 0.5:
            sel = sel[::-1]
        crop = None
        apply_crop = (not self.test) and rng.random() < self.crop_ratio
        frames = []
        for f in sel:
            img = _load_image(f, self.load_color)
            if apply_crop:
                if crop is None:
                    _, H, W = img.shape
                    cw, ch = self.image_size
                    cx = int(rng.integers(0, W - cw + 1))
                    cy = int(rng.integers(0, H - ch + 1))
                    crop = (cx, cy, cw, ch)
                cx, cy, cw, ch = crop
                img = img[:, cy : cy + ch, cx : cx + cw]
            elif not self.test and img.shape[1:] != self.image_size[::-1]:
                # the reference meant to crop or resize (data3d.py:117) but
                # never wrote the resize; without it a batch of uncropped
                # frames larger than the crop cannot stack
                img = _resize(img, self.image_size)
            frames.append(img)
        return frames

    def __getitem__(self, idx: int) -> np.ndarray:
        files = self._frame_files(self.video_dirs[idx])
        if len(files) < self.depth:
            raise ValueError(f"{self.video_dirs[idx]} has fewer than {self.depth} frames")
        rng = self.rng()  # per-item generator, as the JAX package draws
        if not self.test and rng.random() < self.aug_prob:
            frames = self._random_walk(files, rng)
        else:
            frames = self._window(files, rng)
        return np.ascontiguousarray(np.stack(frames, axis=1))  # (C, D, H, W)


def get_video_loader(dir_list, batch_size=1, load_color=False, crop_size=None, test=True,
                     depth=16, crop_ratio=0.5, aug_prob=0.3, max_shift=10, seed=0,
                     num_workers=0):
    size = (crop_size, crop_size) if crop_size else (128, 128)
    ds = VideoClipDataset(dir_list, load_color=load_color, depth=depth, image_size=size,
                          test=test, crop_ratio=crop_ratio, aug_prob=aug_prob,
                          max_shift=max_shift, seed=seed)
    return DataLoader(ds, batch_size=batch_size, shuffle=not test, drop_last=not test,
                      seed=seed, num_workers=num_workers)


def get_video_fit_loaders(trn_path_list=("data_gen/data16/train",),
                          val_path_list=("data_gen/data16/val",),
                          tst_path_list=("data_gen/data16/test",),
                          crop_size=128, batch_size=(10, 1, 1), load_color=False, depth=16,
                          crop_ratio=0.5, aug_prob=0.3, max_shift=10, seed=0,
                          num_workers=0):
    """Train/val/test video loaders (data3d.py:189-255); val and test clips
    are the first `depth` frames of each video at full resolution."""
    if isinstance(batch_size, int):
        batch_size = [batch_size, 1, 1]
    common = dict(load_color=load_color, depth=depth, crop_ratio=crop_ratio,
                  aug_prob=aug_prob, max_shift=max_shift, seed=seed, crop_size=crop_size)
    return {
        "train": get_video_loader(trn_path_list, batch_size[0], test=False,
                                  num_workers=num_workers, **common),
        "val": get_video_loader(val_path_list, batch_size[1], test=True, **common),
        "test": get_video_loader(tst_path_list, batch_size[2], test=True, **common),
    }
