"""fastMRI k-space volumes for evaluation (counterpart of the eval half of
cdlnet_tpu/data/fastmri.py).

Reference semantics (datafastmri.py, test mode): read .h5 single-coil
volumes, optionally keep only acquisition == 'CORPD_FBK' (PDFS=False); per
slice the centered orthonormal 2D inverse FFT (the fastmri package's ifft2c,
here in numpy) and the complex magnitude min-max normalized to uint8; the
first `depth` slices at full size stack to (1, D, H, W). The training half
(random windows and crops) is not ported yet. h5py is imported where a file
is read.
"""

from __future__ import annotations

import os

import numpy as np

from cdlnet_tpu_torch.data.loader import DataLoader


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
    H, W) float32 in [0, 1]: the first `depth` slices at full size."""

    def __init__(self, root_dirs, depth=16, PDFS=True):
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

    def __len__(self):
        return len(self.h5_files)

    def __getitem__(self, idx: int) -> np.ndarray:
        import h5py

        with h5py.File(self.h5_files[idx], "r") as hf:
            vol = hf["kspace"][()]
        if vol.shape[0] < self.depth:
            raise ValueError(
                f"{self.h5_files[idx]} has {vol.shape[0]} slices < depth {self.depth}")
        frames = [kspace_to_uint8_image(vol[i]).astype(np.float32) / 255.0
                  for i in range(self.depth)]
        return np.stack(frames)[None]  # (1, D, H, W)


def get_fastmri_data_loader(dir_list, depth=16, PDFS=True):
    """The eval loader: one (1, 1, depth, H, W) volume per batch, in file
    order."""
    return DataLoader(FastMRIDataset(dir_list, depth=depth, PDFS=PDFS))
