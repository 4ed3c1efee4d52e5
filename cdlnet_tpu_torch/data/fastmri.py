"""fastMRI k-space volumes for training and evaluation (counterpart of
cdlnet_tpu/data/fastmri.py).

Reference semantics (datafastmri.py): read .h5 single-coil volumes,
optionally keep only acquisition == 'CORPD_FBK' (PDFS=False); per slice the
centered orthonormal 2D inverse FFT (the fastmri package's ifft2c, here in
numpy) and the complex magnitude min-max normalized to uint8; `depth`
consecutive slices stack to (1, D, H, W): the first ones at full size for
evaluation, a random window with one shared random crop for training. The
batches come from the sequential loader (data/loader.py), so a seed gives
the JAX loader's batches at num_workers=0. h5py is imported where a file is
read.
"""

from __future__ import annotations

import os

import numpy as np

from cdlnet_tpu_torch.data.loader import DataLoader, ThreadSafeRng


def ifft2c(kspace: np.ndarray) -> np.ndarray:
    """Centered orthonormal 2D inverse FFT over the trailing two axes."""
    x = np.fft.ifftshift(kspace, axes=(-2, -1))
    x = np.fft.ifft2(x, axes=(-2, -1), norm="ortho")
    return np.fft.fftshift(x, axes=(-2, -1))


def kspace_to_uint8_image(kspace_slice: np.ndarray) -> np.ndarray:
    """One k-space slice -> min-max normalized uint8 magnitude image
    (datafastmri.py:86-96)."""
    mag = np.abs(ifft2c(kspace_slice))
    lo, hi = mag.min(), mag.max()
    mag = (mag - lo) / max(hi - lo, 1e-12)
    return (mag * 255).astype(np.uint8)


class FastMRIDataset:
    """The .h5 volumes of root_dirs (file-name order); item i is (1, depth,
    H, W) float32 in [0, 1]. test=True: the first `depth` slices at full
    size. test=False (training): `depth` consecutive slices from a random
    start and one random image_size = (crop width, crop height) crop shared
    by every slice, drawn from a child of the seeded root generator per
    item, so a seed gives the JAX package's volumes."""

    def __init__(self, root_dirs, depth=16, image_size=(128, 128), test=False, PDFS=True,
                 seed=0):
        import h5py

        self.h5_files = []
        for cur in root_dirs:
            files = [os.path.join(cur, f) for f in sorted(os.listdir(cur))
                     if f.lower().endswith(".h5")]
            if not PDFS:
                kept = []
                for f in files:
                    try:
                        with h5py.File(f, "r") as hf:
                            if hf.attrs.get("acquisition") == "CORPD_FBK":
                                kept.append(f)
                    except OSError as e:  # an unreadable file is skipped, as the reference does
                        print(f"Error reading {f}: {e}")
                files = kept
            self.h5_files += files
        self.depth = depth
        self.image_size = tuple(image_size)
        self.test = test
        self.rng = ThreadSafeRng(seed)

    def __len__(self):
        return len(self.h5_files)

    def __getitem__(self, idx: int) -> np.ndarray:
        import h5py

        with h5py.File(self.h5_files[idx], "r") as hf:
            vol = hf["kspace"][()]
        n = vol.shape[0]
        if n < self.depth:
            raise ValueError(f"{self.h5_files[idx]} has {n} slices < depth {self.depth}")
        rng = self.rng()
        start = 0 if self.test else int(rng.integers(0, n - self.depth + 1))
        crop = None
        frames = []
        for i in range(start, start + self.depth):
            img = kspace_to_uint8_image(vol[i])
            if not self.test:
                H, W = img.shape
                cw, ch = self.image_size
                if cw > W or ch > H:
                    raise ValueError(f"crop {self.image_size} > image {(W, H)}")
                if crop is None:
                    crop = (int(rng.integers(0, W - cw + 1)), int(rng.integers(0, H - ch + 1)))
                cx, cy = crop
                img = img[cy:cy + ch, cx:cx + cw]
            frames.append(img.astype(np.float32) / 255.0)
        return np.stack(frames)[None]  # (1, D, H, W)


def get_fastmri_data_loader(dir_list, batch_size=1, crop_size=128, test=True, depth=16,
                            PDFS=True, seed=0, num_workers=0):
    """(B, 1, depth, H, W) batches of FastMRIDataset: in file order at full
    size (test=True, the eval loader), or shuffled per epoch, crop_size^2
    crops and the last short batch dropped (test=False); num_workers
    threads assemble them (data/loader.py)."""
    ds = FastMRIDataset(dir_list, depth=depth, image_size=(crop_size, crop_size),
                        test=test, PDFS=PDFS, seed=seed)
    return DataLoader(ds, batch_size=batch_size, shuffle=not test, drop_last=not test,
                      seed=seed, num_workers=num_workers)


class VolumeToBatchLoader:
    """Feeds 2D nets from slice-volume loaders: each (B, C, D, H, W) batch
    becomes (B*D, C, H, W), the slices in the batch dim. The reference
    (traincsr.py:163-165) permutes to (D, C, H, W, B) and squeezes B, which
    works at B = 1 only; this takes any B, as the JAX package does."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        for b in self.loader:
            b = np.asarray(b)
            B, C, D, H, W = b.shape
            yield np.ascontiguousarray(np.moveaxis(b, 2, 1)).reshape(B * D, C, H, W)

    def __len__(self):
        return len(self.loader)


def volume_to_batch_loaders(loaders: dict) -> dict:
    """Every split of a fastMRI fit-loader dict, for 2D-net training."""
    return {k: VolumeToBatchLoader(v) for k, v in loaders.items()}


def get_fastmri_fit_loaders(trn_path_list, val_path_list, tst_path_list, crop_size=128,
                            batch_size=(10, 1, 1), load_color=False, depth=16, PDFS=True,
                            seed=0, num_workers=0):
    """The train / val / test loaders of the fastMRI training schema
    (argscsr.json's "loaders"): random windows and crops, shuffled, for
    train; the first `depth` slices at full size for val and test. The
    train loader assembles its batches in num_workers threads.
    batch_size: one int (train; val and test take 1) or three. load_color
    is the schema's key and unused: the volumes are grayscale."""
    if isinstance(batch_size, int):
        batch_size = [batch_size, 1, 1]
    return {
        "train": get_fastmri_data_loader(trn_path_list, batch_size[0], crop_size=crop_size,
                                         test=False, depth=depth, PDFS=PDFS, seed=seed,
                                         num_workers=num_workers),
        "val": get_fastmri_data_loader(val_path_list, batch_size[1], crop_size=crop_size,
                                       test=True, depth=depth, PDFS=PDFS),
        "test": get_fastmri_data_loader(tst_path_list, batch_size[2], crop_size=crop_size,
                                        test=True, depth=depth, PDFS=PDFS),
    }
