"""2D image-directory dataset and loaders (the port's own copy of
cdlnet_tpu/data/images.py: the same crops, flips and batches for a seed).

Reference semantics (data.py): eager-load every image under the given dirs
(grayscale via L-conversion unless load_color); train transform =
RandomCrop(crop_size) + random H/V flips; test = full image; train loader
shuffles and drops the last partial batch, assembled in num_workers
threads (data/loader.py). Batches are numpy arrays (N, C, H, W) in [0, 1];
fit() moves them to the model's device. PIL is
imported where an image is decoded, and only there.
"""

from __future__ import annotations

import os

import numpy as np

from cdlnet_tpu_torch.data.loader import DataLoader, ThreadSafeRng

IMG_EXTS = ("tif", "tiff", "png", "jpg", "jpeg", "bmp")


def _load_image(path: str, load_color: bool) -> np.ndarray:
    """Returns (C, H, W) float32 in [0,1]."""
    from PIL import Image

    img = Image.open(path)
    img = img.convert("RGB") if load_color else img.convert("L")
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return arr


class ImageDataset:
    """Eager-loads all images from root_dirs (data.py:12-36)."""

    def __init__(self, root_dirs, load_color=False, crop_size=None, augment=False, seed=0):
        self.image_paths = []
        for cur in root_dirs:
            self.image_paths += [
                os.path.join(cur, f)
                for f in sorted(os.listdir(cur))
                if f.lower().endswith(IMG_EXTS)
            ]
        self.images = [_load_image(p, load_color) for p in self.image_paths]
        self.root_dirs = list(root_dirs)
        self.crop_size = crop_size
        self.augment = augment
        self.rng = ThreadSafeRng(seed)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int) -> np.ndarray:
        x = self.images[idx]
        rng = self.rng()  # per-item generator, as the JAX package draws
        if self.crop_size is not None:
            c = self.crop_size
            _, H, W = x.shape
            i = int(rng.integers(0, H - c + 1))
            j = int(rng.integers(0, W - c + 1))
            x = x[:, i : i + c, j : j + c]
        if self.augment:
            if rng.random() < 0.5:
                x = x[:, :, ::-1]
            if rng.random() < 0.5:
                x = x[:, ::-1, :]
        return np.ascontiguousarray(x)


def get_data_loader(dir_list, batch_size=1, load_color=False, crop_size=None, test=True, seed=0,
                    num_workers=0):
    ds = ImageDataset(
        dir_list,
        load_color=load_color,
        crop_size=None if test else crop_size,
        augment=not test,
        seed=seed,
    )
    return DataLoader(ds, batch_size=batch_size, shuffle=not test, drop_last=not test, seed=seed,
                      num_workers=num_workers)


def get_fit_loaders(
    trn_path_list=("CBSD432",),
    val_path_list=("Kodak",),
    tst_path_list=("CBSD68",),
    crop_size=128,
    batch_size=(10, 1, 1),
    load_color=False,
    seed=0,
    num_workers=0,
):
    """Train/val/test loader dict (data.py:52-75)."""
    if isinstance(batch_size, int):
        batch_size = [batch_size, 1, 1]
    return {
        "train": get_data_loader(
            trn_path_list, batch_size[0], load_color, crop_size=crop_size, test=False,
            seed=seed, num_workers=num_workers,
        ),
        "val": get_data_loader(val_path_list, batch_size[1], load_color, test=True),
        "test": get_data_loader(tst_path_list, batch_size[2], load_color, test=True),
    }
