"""Synthetic image, video and fastMRI fixtures (the port's own copy of
cdlnet_tpu/data/synthetic.py): random smooth fields from mixed sin/cos
terms on a (-pi, pi)^3 grid, natural-statistics images, PNG image
directories of either for the 2D loaders, PNG frame directories of the
fields for the video loaders and the CLIs, and .h5 k-space volumes of them
for the fastMRI loader. Fully seeded: a seed gives the JAX package's arrays
and files. PIL and h5py are imported only where a file is written.
"""

from __future__ import annotations

import os

import numpy as np


def random_field_video(rng, depth=16, size=128, n_terms=6) -> np.ndarray:
    """Returns (depth, size, size) float32 in [0, 1]."""
    t = np.linspace(-np.pi, np.pi, depth, dtype=np.float32)
    y = np.linspace(-np.pi, np.pi, size, dtype=np.float32)
    x = np.linspace(-np.pi, np.pi, size, dtype=np.float32)
    T, Y, X = np.meshgrid(t, y, x, indexing="ij")
    field = np.zeros_like(T)
    for _ in range(n_terms):
        a, b, c = rng.uniform(0.5, 3.0, 3)
        ph = rng.uniform(0, 2 * np.pi, 3)
        amp = rng.uniform(0.3, 1.0)
        fn1 = np.sin if rng.random() < 0.5 else np.cos
        fn2 = np.sin if rng.random() < 0.5 else np.cos
        field += amp * fn1(a * X + ph[0]) * fn2(b * Y + ph[1]) * np.cos(c * T + ph[2])
    lo, hi = field.min(), field.max()
    return ((field - lo) / max(hi - lo, 1e-8)).astype(np.float32)


def gen_synthetic_video_dirs(out_dir: str, n_videos=4, depth=16, size=128, seed=0,
                             splits=("train", "val", "test")):
    """Write PNG frame dirs: out_dir/{split}/video{i:03d}/frame{j:03d}.png."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split in splits:
        for i in range(n_videos):
            vdir = os.path.join(out_dir, split, f"video{i:03d}")
            os.makedirs(vdir, exist_ok=True)
            vid = random_field_video(rng, depth=depth, size=size)
            for j in range(depth):
                frame = (vid[j] * 255).astype(np.uint8)
                Image.fromarray(frame, mode="L").save(
                    os.path.join(vdir, f"frame{j:03d}.png"))
    return out_dir


def volume_kspace(vol: np.ndarray) -> np.ndarray:
    """Centered orthonormal 2D FFT of each slice of a (D, H, W) volume, as
    complex64: the k-space that data/fastmri.py's ifft2c inverts."""
    k = np.fft.fftshift(
        np.fft.fft2(np.fft.ifftshift(vol, axes=(-2, -1)), axes=(-2, -1), norm="ortho"),
        axes=(-2, -1),
    )
    return k.astype(np.complex64)


def gen_synthetic_mri_dirs(out_dir: str, n_volumes=2, slices=16, size=128, seed=0,
                           splits=("train", "val", "test")):
    """Write fastMRI-style .h5 k-space volume dirs: out_dir/{split}/vol{i:03d}.h5.

    Each volume is a random_field_video slice stack through volume_kspace,
    tagged acquisition='CORPD_FBK' so that it survives the PDFS=False
    filter (the reference's datafastmri.py:34-46)."""
    import h5py

    rng = np.random.default_rng(seed)
    for split in splits:
        sdir = os.path.join(out_dir, split)
        os.makedirs(sdir, exist_ok=True)
        for i in range(n_volumes):
            vol = random_field_video(rng, depth=slices, size=size)
            with h5py.File(os.path.join(sdir, f"vol{i:03d}.h5"), "w") as hf:
                hf.create_dataset("kspace", data=volume_kspace(vol))
                hf.attrs["acquisition"] = "CORPD_FBK"
    return out_dir


def natural_image(rng, size=180) -> np.ndarray:
    """One (size, size) float32 [0,1] image with natural-image statistics:
    a piecewise-smooth 'cartoon' component (random shaded ellipses and
    half-plane edges over a background gradient) plus 1/f^alpha pink-noise
    texture — the edge + texture structure convolutional dictionary
    learning actually trains on, unlike pure sin/cos fields.

    The JAX package's flagship PSNR gate (tools/flagship_gate.py) trains
    and evaluates on this corpus; chip_smoke.py cuts its 2D training crops
    from it in memory."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    yy = yy / size
    xx = xx / size

    # background: smooth low-order gradient
    g = rng.uniform(-1, 1, 3)
    img = 0.5 + 0.25 * (g[0] * xx + g[1] * yy + g[2] * xx * yy)

    # cartoon: shaded ellipses (sharp boundaries = edges at all orientations)
    for _ in range(rng.integers(6, 14)):
        cy, cx = rng.uniform(0, 1, 2)
        ry, rx = rng.uniform(0.04, 0.35, 2)
        th = rng.uniform(0, np.pi)
        c, s = np.cos(th), np.sin(th)
        u = (xx - cx) * c + (yy - cy) * s
        v = -(xx - cx) * s + (yy - cy) * c
        inside = (u / rx) ** 2 + (v / ry) ** 2 < 1.0
        shade = rng.uniform(0.1, 0.9) + rng.uniform(-0.3, 0.3) * u / rx
        img = np.where(inside, 0.35 * img + 0.65 * shade, img)

    # a couple of straight edges (half-plane steps)
    for _ in range(rng.integers(1, 4)):
        th = rng.uniform(0, 2 * np.pi)
        off = rng.uniform(0.2, 0.8)
        half = (np.cos(th) * xx + np.sin(th) * yy) > off
        img = np.where(half, img * rng.uniform(0.5, 1.0) + rng.uniform(-0.15, 0.15), img)

    # texture: 1/f^alpha pink noise (natural-image power spectrum)
    alpha = rng.uniform(1.0, 1.6)
    f = np.fft.fftfreq(size)
    fr = np.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
    fr[0, 0] = 1.0
    spec = (rng.standard_normal((size, size)) + 1j * rng.standard_normal((size, size)))
    tex = np.real(np.fft.ifft2(spec / fr**alpha))
    tex = tex / max(tex.std(), 1e-8)
    img = img + rng.uniform(0.02, 0.08) * tex

    lo, hi = np.percentile(img, 0.5), np.percentile(img, 99.5)
    return np.clip((img - lo) / max(hi - lo, 1e-8), 0.0, 1.0).astype(np.float32)


def gen_natural_image_dirs(
    out_dir: str, n_train=48, n_test=12, size=180, seed=0
):
    """Natural-statistics corpus: out_dir/{train,val,test}/img{i}.png. Deterministic; val reuses the last 8 train images'
    RNG stream (distinct draws). Includes center/corner crops of the one
    real photograph available offline (matplotlib's grace_hopper sample)
    in every split's pool."""
    from PIL import Image

    def hopper_crops():
        try:
            import matplotlib

            p = os.path.join(matplotlib.get_data_path(), "sample_data", "grace_hopper.jpg")
            im = Image.open(p).convert("L")
            a = np.asarray(im, np.float32) / 255.0
            H, W = a.shape
            out = []
            for oy in (0, H - size):
                for ox in (0, W - size):
                    out.append(a[oy : oy + size, ox : ox + size])
            return out
        except Exception:
            return []

    rng = np.random.default_rng(seed)
    hop = hopper_crops()
    counts = {"train": n_train, "val": 8, "test": n_test}
    for split, n in counts.items():
        sdir = os.path.join(out_dir, split)
        os.makedirs(sdir, exist_ok=True)
        for i in range(n):
            if hop and i == n - 1:  # one real-photo crop per split
                img = hop[{"train": 0, "val": 1, "test": 2}[split] % len(hop)]
            else:
                img = natural_image(rng, size=size)
            Image.fromarray((img * 255).round().astype(np.uint8), mode="L").save(
                os.path.join(sdir, f"img{i:03d}.png")
            )
    return out_dir


def gen_synthetic_image_dirs(out_dir: str, n_images=8, size=180, seed=0, splits=("train", "val", "test")):
    """Write PNG image dirs for the 2D pipeline: out_dir/{split}/img{i}.png."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split in splits:
        sdir = os.path.join(out_dir, split)
        os.makedirs(sdir, exist_ok=True)
        for i in range(n_images):
            img = random_field_video(rng, depth=1, size=size)[0]
            Image.fromarray((img * 255).astype(np.uint8), mode="L").save(
                os.path.join(sdir, f"img{i:03d}.png")
            )
    return out_dir
