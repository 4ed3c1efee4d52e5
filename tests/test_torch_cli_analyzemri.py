"""The port's fastMRI / CSR analysis CLI (cli/analyzemri.py), the SSIM it
logs (train/losses.py) and the fastMRI loader (data/fastmri.py) on the CPU,
against the JAX package's.

The two CLIs draw their noise from different generators, so the
comparisons of their files feed both the same noise: each package's awgn3d
is replaced by one that adds seeded numpy noise. Both CLIs then load the
same checkpoint — the trained examples/csr-demo, or a small model of
another type written by the port — and their txt lines, metrics rows and
PNG names must agree; the txt byte for byte."""

import json
import os
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cdlnet_tpu.cli import analyzemri as jax_analyzemri
from cdlnet_tpu.cli.analyze import build_argparser as jax_build_argparser
from cdlnet_tpu.data.fastmri import get_fastmri_data_loader as jax_get_fastmri_data_loader
from cdlnet_tpu.data.synthetic import gen_synthetic_mri_dirs as jax_gen_synthetic_mri_dirs
from cdlnet_tpu.train.losses import ssim as jax_ssim
from cdlnet_tpu_torch.cli import analyzemri
from cdlnet_tpu_torch.cli.analyze import build_argparser
from cdlnet_tpu_torch.data.fastmri import get_fastmri_data_loader
from cdlnet_tpu_torch.data.synthetic import gen_synthetic_mri_dirs, random_field_video
from cdlnet_tpu_torch.train.checkpoint import save_ckpt
from cdlnet_tpu_torch.train.fit import init_model
from cdlnet_tpu_torch.train.losses import ssim
from cdlnet_tpu_torch.utils import img_save

ROOT = os.path.join(os.path.dirname(__file__), "..")
CSR_DEMO = os.path.join(ROOT, "examples", "csr-demo")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mri_dirs(tmp_path_factory):
    """Two 5-slice 128x128 volumes per split, written by the port: the
    generator's default frame size, on which the csr-demo's committed eval
    ran (it was trained on 64^2 crops; on 32^2 frames its borders cost more
    than it denoises)."""
    return gen_synthetic_mri_dirs(str(tmp_path_factory.mktemp("mri")), n_volumes=2,
                                  slices=5, size=128)


def _smooth_pair(noise):
    x = random_field_video(np.random.default_rng(0), depth=4, size=48)[:, None]
    rng = np.random.default_rng(1)
    y = np.clip(x + noise * rng.standard_normal(x.shape, np.float32), -0.2, 1.2)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("noise", [0.0, 0.05, 0.3])
def test_ssim_matches_jax(noise):
    """The gaussian-window SSIM on smooth fields (the shape that broke the
    TPU's default precision, tests/test_losses.py), clean to very noisy."""
    x, y = _smooth_pair(noise)
    got = float(ssim(torch.from_numpy(y), torch.from_numpy(x)))
    want = float(jax_ssim(jnp.asarray(y), jnp.asarray(x)))
    assert got == pytest.approx(want, abs=2e-6)
    assert -1.0 <= got <= 1.0


@pytest.mark.parametrize("PDFS", [True, False])
def test_fastmri_loader_matches_jax(tmp_path, PDFS):
    """Both packages' generators write the same k-space arrays; the port's
    eval loader gives the JAX test-mode loader's batches from them, the
    first slices at full size, over two epochs, with every file
    (PDFS=True) or the CORPD_FBK acquisitions only (PDFS=False)."""
    import h5py

    kw = dict(n_volumes=3, slices=6, size=24, seed=2)
    tdata = gen_synthetic_mri_dirs(str(tmp_path / "t"), **kw)
    jdata = jax_gen_synthetic_mri_dirs(str(tmp_path / "j"), **kw)
    name = os.path.join("val", "vol001.h5")
    with h5py.File(os.path.join(tdata, name)) as a, h5py.File(os.path.join(jdata, name)) as b:
        np.testing.assert_array_equal(a["kspace"][()], b["kspace"][()])
        assert a.attrs["acquisition"] == b.attrs["acquisition"] == "CORPD_FBK"
    port = get_fastmri_data_loader([os.path.join(tdata, "train")], depth=4, PDFS=PDFS)
    ref = jax_get_fastmri_data_loader([os.path.join(tdata, "train")], batch_size=1,
                                      test=True, depth=4, PDFS=PDFS)
    assert port.dataset.h5_files == ref.dataset.h5_files
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert got[0].shape == (1, 1, 4, 24, 24)


def _numpy_noise(shape, sigma):
    rng = np.random.default_rng(int(sigma) * 1000 + int(np.prod(shape)) % 997)
    return (float(sigma) / 255.0 * rng.standard_normal(shape)).astype(np.float32)


def _jax_awgn3d(key, x, sigma):
    return x + jnp.asarray(_numpy_noise(x.shape, sigma)), jnp.asarray(sigma, jnp.float32)


def _torch_awgn3d(x, sigma, generator=None):
    noise = torch.from_numpy(_numpy_noise(tuple(x.shape), sigma)).to(x.device)
    return x + noise, torch.as_tensor(sigma, dtype=x.dtype, device=x.device)


def _same_eval_lines(jax_txt, torch_txt, jax_rows, torch_rows):
    """The two CLIs' "sigma, PSNR: p, SSIM: s" lines are the same bytes. The
    one exception is fp32 reassociation at a rounding boundary: a printed
    PSNR or SSIM may differ by one unit in its last digit where the two
    unrounded values (the metrics rows) are within 1e-5 of each other."""
    jl, tl = jax_txt.decode().splitlines(), torch_txt.decode().splitlines()
    assert len(jl) == len(tl) == len(jax_rows) == len(torch_rows)
    for a, b, jr, tr in zip(jl, tl, jax_rows, torch_rows):
        if a == b:
            continue
        fa, fb = a.split(", "), b.split(", ")
        assert fa[0] == fb[0], (a, b)
        for (key, digits), x, y in zip((("psnr", 3), ("ssim", 4)), fa[1:], fb[1:]):
            if x != y:
                unit = 10.0 ** -digits
                va, vb = float(x.split(": ")[1]), float(y.split(": ")[1])
                assert abs(va - vb) == pytest.approx(unit) and \
                    abs(jr[key] - tr[key]) <= 1e-5, (a, b)
    assert jax_txt.endswith(b"\n") and torch_txt.endswith(b"\n")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _rows(save):
    with open(os.path.join(save, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(x).items() if k != "ts"} for x in f if x.strip()]


# small models of the other dispatch types: (type, model config, depth)
SMALL = {
    "csr": ("CDLNet_CSR", dict(K=3, M=8, P=5, s=2, C=1, adaptive=True), 3),
    "cdlnet": ("CDLNet", dict(K=3, M=8, P=5, s=2, C=1, adaptive=True), 5),
    "video": ("CDLNetVideo", dict(K=2, M=6, P=[3, 3, 3], s=2, C=1, adaptive=True,
                                  depth=4), 4),
}


def _args(case, tmp_path):
    """The case's args.json with paths.save under tmp_path and a checkpoint
    both CLIs load: the csr-demo's, or one the port writes from its init
    (CDLNet_CSR's first-frame banks set to the primary ones, as parity runs
    set them)."""
    if case == "csr-demo":
        with open(os.path.join(CSR_DEMO, "args.json")) as f:
            args = json.load(f)
        args["paths"] = {"ckpt": os.path.join(CSR_DEMO, "net.ckpt.npz")}
        return args
    mtype, cfg, depth = SMALL[case]
    args = {"type": mtype, "model": dict(cfg),
            "train": {"fit": {"noise_std": [20, 30]}, "loaders": {"depth": depth},
                      "opt": {"lr": 1e-3}}, "paths": {}}
    model, _, state, _, lr = init_model(args, device="cpu")
    with torch.no_grad():
        model.t.uniform_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
        if mtype == "CDLNet_CSR":
            model.A2.copy_(model.A)
            model.B2.copy_(model.B)
            model.g.fill_(0.5)
    ckpt = str(tmp_path / f"{case}.ckpt.npz")
    save_ckpt(ckpt, model, 0, state, lr)
    args["paths"] = {"ckpt": ckpt}
    return args


@pytest.mark.parametrize("case,blind", [("csr-demo", None), ("csr-demo", "MAD"),
                                        ("csr", None), ("cdlnet", "MAD"), ("video", None)])
def test_cli_writes_the_jax_clis_files(mri_dirs, tmp_path, monkeypatch, case, blind):
    """Both CLIs on the same volumes, weights and noise: the same txt bytes
    ("sigma, PSNR: p, SSIM: s"), eval rows and PNG names, for CDLNet_CSRf2
    (the trained demo), CDLNet_CSR, a 2D CDLNet and CDLNetVideo."""
    import cdlnet_tpu.data.noise as jax_noise

    monkeypatch.setattr(jax_noise, "awgn3d", _jax_awgn3d)
    monkeypatch.setattr(analyzemri, "awgn3d", _torch_awgn3d)
    test_dir = os.path.join(mri_dirs, "test")
    argv = ["args.json", "--test", test_dir, "--noise_level", "15", "25", "--save"]
    if blind:
        argv += ["--blind", blind]
    saves = {}
    for pkg in ("jax", "torch"):
        args = _args(case, tmp_path)
        args["paths"]["save"] = saves[pkg] = str(tmp_path / pkg)
        if pkg == "jax":
            jax_analyzemri.main(jax_build_argparser().parse_args(argv + ["--backend", "xla"]),
                                args)
        else:
            analyzemri.main(build_argparser().parse_args(argv), args, device="cpu")
    name = f"test_test_{blind}.txt"
    with open(os.path.join(saves["jax"], name), "rb") as a, \
            open(os.path.join(saves["torch"], name), "rb") as b:
        jtxt, txt = a.read(), b.read()
    jrows, trows = _rows(saves["jax"]), _rows(saves["torch"])
    _same_eval_lines(jtxt, txt, jrows, trows)
    lines = txt.decode().splitlines()
    assert [ln.split(", ")[0] for ln in lines] == ["15", "25"]
    assert all(ln.split(", ")[1].startswith("PSNR: ") for ln in lines)
    depth = 3 if case == "csr-demo" else SMALL[case][2]
    for jr, tr in zip(jrows, trows):
        assert tr.keys() == jr.keys() and tr["volumes"] == jr["volumes"] == 2
        assert tr["frames"] == jr["frames"] == 2 * depth
        assert abs(tr["psnr"] - jr["psnr"]) < 1e-3 and abs(tr["ssim"] - jr["ssim"]) < 1e-4
    assert _files(saves["torch"]) == _files(saves["jax"])
    assert os.path.join("test_gt", f"gt_{2 * depth:05d}.png") in _files(saves["torch"])


def test_csr_demo_denoises_mri_volumes(mri_dirs):
    """The trained csr-demo (CDLNet_CSRf2) on the port's own noise, at the
    sigmas of its committed test_test_None.txt: every volume gains >= 3 dB
    over its noisy PSNR, with SSIM in (0, 1]."""
    with open(os.path.join(CSR_DEMO, "args.json")) as f:
        args = json.load(f)
    args["paths"] = {"ckpt": os.path.join(CSR_DEMO, "net.ckpt.npz")}
    model = init_model(args, device="cpu")[0].eval()
    loader = get_fastmri_data_loader([os.path.join(mri_dirs, "test")], depth=3, PDFS=False)
    run = analyzemri.forward_for(model, "CDLNet_CSRf2")
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        for sigma in (15, 25, 35):
            for x in loader:
                x = torch.from_numpy(x)
                y = x + sigma / 255 * torch.randn(x.shape, generator=gen)
                xhat = run(y, float(sigma))
                gain = 10 * np.log10(float(((y - x) ** 2).mean()) /
                                     float(((xhat - x) ** 2).mean()))
                assert gain > 3.0
                assert 0.0 < analyzemri._ssim_frames(x, xhat) <= 1.0


@pytest.mark.parametrize("case", ["csr-demo", "csr"])
def test_passthrough_csr_matches_jax(tmp_path, monkeypatch, case):
    """--passthrough on a directory of PNG frames through the recurrence:
    the same psnr.txt and frame files as the JAX CLI's."""
    import cdlnet_tpu.data.noise as jax_noise

    monkeypatch.setattr(jax_noise, "awgn3d", _jax_awgn3d)
    monkeypatch.setattr(analyzemri, "awgn3d", _torch_awgn3d)
    vdir = tmp_path / "frames"
    vdir.mkdir()
    for j, frame in enumerate(random_field_video(np.random.default_rng(3), depth=4,
                                                 size=32)):
        img_save(str(vdir / f"{j:05d}.png"), frame[None])
    argv = ["args.json", "--passthrough", str(vdir), "--noise_level", "25", "--save"]
    saves = {}
    for pkg in ("jax", "torch"):
        args = _args(case, tmp_path)
        args["paths"]["save"] = saves[pkg] = str(tmp_path / pkg)
        if pkg == "jax":
            jax_analyzemri.main(jax_build_argparser().parse_args(argv + ["--backend", "xla"]),
                                args)
        else:
            analyzemri.main(build_argparser().parse_args(argv), args, device="cpu")
    name = os.path.join("passthrough_frames", "psnr.txt")
    assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert _files(saves["torch"]) == _files(saves["jax"])
    assert os.path.join("passthrough_frames", "output_00004.png") in _files(saves["torch"])


def test_pca_raises(mri_dirs, tmp_path):
    """--blind PCA (which raised before it was ported; held to JAX's
    framewise estimate in tests/test_torch_nle_pca.py) writes its
    "sigma, PSNR: p, SSIM: s" line."""
    args = _args("csr", tmp_path)
    args["paths"]["save"] = str(tmp_path)
    analyzemri.main(build_argparser().parse_args(
        ["args.json", "--test", os.path.join(mri_dirs, "test"), "--noise_level", "25",
         "--blind", "PCA"]), args, device="cpu")
    (line,) = (tmp_path / "test_test_PCA.txt").read_text().splitlines()
    assert re.fullmatch(r"25, PSNR: \d+\.\d{3}, SSIM: \d\.\d{4}", line), line
