"""The port's video analysis CLI (cli/analyze3d.py), video loaders
(data/video.py) and the train CLI's video branch on the CPU, against the
JAX package's.

The two CLIs draw their noise from different generators, so the
comparisons of their files feed both the same noise: each package's awgn3d
is replaced by one that adds seeded numpy noise. The CLIs then run the
trained examples/cdlnet-video-demo on the same clips, and their txt,
metrics rows and PNG names must agree; the txt byte for byte."""

import json
import os

import numpy as np
import pytest
import torch

from cdlnet_tpu.cli import analyze3d as jax_analyze3d
from cdlnet_tpu.cli.analyze import build_argparser as jax_build_argparser
from cdlnet_tpu.data.synthetic import gen_synthetic_video_dirs as jax_gen_video_dirs
from cdlnet_tpu.data.video import get_video_fit_loaders as jax_get_video_fit_loaders
from cdlnet_tpu_torch.cli import analyze3d
from cdlnet_tpu_torch.cli import train as cli_train
from cdlnet_tpu_torch.cli.analyze import build_argparser
from cdlnet_tpu_torch.data.synthetic import gen_synthetic_video_dirs
from cdlnet_tpu_torch.data.video import get_video_fit_loaders
from cdlnet_tpu_torch.train.fit import init_model

ROOT = os.path.join(os.path.dirname(__file__), "..")
DEMO = os.path.join(ROOT, "examples", "cdlnet-video-demo")


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
def video_dirs(tmp_path_factory):
    """Two 16-frame 32x32 videos per split, written by the port."""
    return gen_synthetic_video_dirs(str(tmp_path_factory.mktemp("vids")), n_videos=2,
                                    depth=16, size=32)


def _demo_args(save):
    with open(os.path.join(DEMO, "args.json")) as f:
        args = json.load(f)
    args["paths"] = {"save": save, "ckpt": os.path.join(DEMO, "net.ckpt.npz")}
    return args


def _numpy_noise(shape, sigma):
    rng = np.random.default_rng(int(sigma) * 1000 + int(np.prod(shape)) % 997)
    return (float(sigma) / 255.0 * rng.standard_normal(shape)).astype(np.float32)


def _jax_awgn3d(key, x, sigma):
    import jax.numpy as jnp

    return x + jnp.asarray(_numpy_noise(x.shape, sigma)), jnp.asarray(sigma, jnp.float32)


def _torch_awgn3d(x, sigma, generator=None):
    noise = torch.from_numpy(_numpy_noise(tuple(x.shape), sigma)).to(x.device)
    return x + noise, torch.as_tensor(sigma, dtype=x.dtype, device=x.device)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _rows(save):
    with open(os.path.join(save, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(x).items() if k != "ts"} for x in f if x.strip()]


FLAGS = ["--noise_level", "15", "25", "--save", "--dictionary", "--filters", "--thresholds"]


def test_cli_writes_the_jax_clis_files(video_dirs, tmp_path, monkeypatch):
    """Both CLIs on the same clips, weights and noise: the same txt bytes,
    eval rows, PNG names and passthrough PSNR."""
    import cdlnet_tpu.data.noise as jax_noise

    monkeypatch.setattr(jax_noise, "awgn3d", _jax_awgn3d)
    monkeypatch.setattr(analyze3d, "awgn3d", _torch_awgn3d)
    test_dir = os.path.join(video_dirs, "test")
    vdir = os.path.join(test_dir, "video000")
    argv = ["args.json", "--test", test_dir, "--passthrough", vdir, *FLAGS]
    jsave, tsave = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_analyze3d.main(jax_build_argparser().parse_args(argv + ["--backend", "xla"]),
                       _demo_args(jsave))
    analyze3d.main(build_argparser().parse_args(argv), _demo_args(tsave), device="cpu")

    for name in ("test_test_None.txt", f"passthrough_video000{os.sep}psnr.txt"):
        with open(os.path.join(jsave, name), "rb") as a, open(os.path.join(tsave, name),
                                                              "rb") as b:
            assert a.read() == b.read(), name
    lines = open(os.path.join(tsave, "test_test_None.txt")).read().splitlines()
    assert [ln.split(", ")[0] for ln in lines] == ["15", "25"]
    jrows, trows = _rows(jsave), _rows(tsave)
    assert [r["event"] for r in trows] == ["eval", "eval"]
    for jr, tr in zip(jrows, trows):
        assert tr.keys() == jr.keys() and tr["clips"] == jr["clips"] == 2
        assert tr["frames"] == jr["frames"] == 32
        assert abs(tr["psnr"] - jr["psnr"]) < 1e-3
    assert _files(tsave) == _files(jsave)
    assert {"tau.png", "D_learned.png", "freq_response.png",
            os.path.join("filters", "AB00_True.png"),
            os.path.join("test_output", "output_00032.png"),
            os.path.join("passthrough_video000", "csc07.png"),
            os.path.join("passthrough_video000", "compare_00016.png")} <= set(_files(tsave))


def test_cli_end_to_end_blind_and_defaults(video_dirs, tmp_path):
    """The CLI with its own noise and blind MAD on the kernels' plain
    versions: finite PSNRs that beat the noisy input; the noise level
    defaults to the config's; so with --blind PCA."""
    test_dir = os.path.join(video_dirs, "test")
    args = _demo_args(str(tmp_path))
    args["train"]["fit"]["noise_std"] = 25
    analyze3d.main(build_argparser().parse_args(
        ["args.json", "--test", test_dir, "--blind", "MAD"]), args, device="cpu")
    (line,) = open(tmp_path / "test_test_MAD.txt").read().splitlines()
    sigma, p = line.split(", ")
    assert sigma == "25" and 22.0 < float(p) < 60.0  # the noisy input is ~20.2 dB
    (row,) = _rows(str(tmp_path))
    assert row["blind"] == "MAD" and row["sigma"] == 25.0
    analyze3d.main(build_argparser().parse_args(
        ["args.json", "--test", test_dir, "--blind", "PCA"]), args, device="cpu")
    (line,) = open(tmp_path / "test_test_PCA.txt").read().splitlines()
    sigma, p = line.split(", ")
    assert sigma == "25" and 22.0 < float(p) < 60.0
    assert [r["blind"] for r in _rows(str(tmp_path))] == ["MAD", "PCA"]


def test_passthrough_codes_match_the_plain_loop(video_dirs, tmp_path):
    """apply_with_codes on the kernels' plain versions and on the plain
    loop ("xla") give the same per-iteration codes for the passthrough."""
    model = init_model(_demo_args(str(tmp_path)), device="cpu")[0]
    plain = init_model(dict(_demo_args(str(tmp_path)), model=dict(
        _demo_args("")["model"], backend="xla")), device="cpu")[0]
    x = torch.from_numpy(analyze3d.load_video(os.path.join(video_dirs, "val", "video001")))
    with torch.inference_mode():
        got = model.apply_with_codes(x, 25.0)
        want = plain.apply_with_codes(x, 25.0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("aug_prob", [0.0, 0.5, 1.0])
def test_video_loaders_match_jax(tmp_path, aug_prob):
    """The port's video loaders give the JAX loaders' batches for a seed:
    random-walk crops, windows, reversals, shared crops and resizes in
    train mode, whole first-16-frame clips in test mode, over two
    epochs; the port's frame files are the JAX package's."""
    kw = dict(n_videos=3, depth=20, size=40, seed=3)
    tdata = gen_synthetic_video_dirs(str(tmp_path / "t"), **kw)
    jdata = jax_gen_video_dirs(str(tmp_path / "j"), **kw)
    vdir = os.path.join("train", "video001")
    for f in sorted(os.listdir(os.path.join(tdata, vdir))):
        assert open(os.path.join(tdata, vdir, f), "rb").read() == \
            open(os.path.join(jdata, vdir, f), "rb").read()
    lkw = dict(crop_size=24, batch_size=(2, 1, 2), depth=16, crop_ratio=0.5,
               aug_prob=aug_prob, max_shift=3, seed=7)
    paths = {f"{k}_path_list": [os.path.join(tdata, s)]
             for k, s in (("trn", "train"), ("val", "val"), ("tst", "test"))}
    port = get_video_fit_loaders(**paths, **lkw)
    ref = jax_get_video_fit_loaders(**paths, **lkw)
    for phase in ("train", "train", "val", "test"):
        got, want = list(port[phase]), list(ref[phase])
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_train_cli_trains_cdlnet_video(video_dirs, tmp_path):
    """cli.train.main on video directories: two training steps of the demo
    width from its checkpoint (epoch 150, so this run is epoch 151 and
    has no test phase), val on whole clips, the checkpoint and args.json
    saved and reloadable."""
    args = _demo_args(str(tmp_path))
    args["train"]["fit"].update(epochs=1, val_freq=1, save_freq=1, verbose=False)
    args["train"]["loaders"].update(
        batch_size=[1, 1, 1], crop_size=16, num_workers=2,
        **{f"{k}_path_list": [os.path.join(video_dirs, s)]
           for k, s in (("trn", "train"), ("val", "val"), ("tst", "test"))})
    loaders, workload = cli_train.make_loaders(args)
    assert workload == "3d" and len(loaders["train"]) == 2
    state, history = cli_train.main(args, device="cpu")
    assert [(e, ph) for e, ph, _ in history] == [(151, "train"), (151, "val")]
    assert all(np.isfinite(p) for _, _, p in history)
    with open(tmp_path / "args.json") as f:
        saved = json.load(f)
    model, _, back_state, epoch0, _ = init_model(saved, device="cpu")
    assert epoch0 == 151 and int(back_state["count"]) == int(state["count"])
    assert model.K == 8


def test_utils_match_jax(tmp_path):
    """The IO helpers the CLIs use against the JAX package's on the same
    arrays: psnr and make_grid give the same values; img_save and save_gif
    write the same bytes; img_load and load_video read the same arrays."""
    from cdlnet_tpu import utils as jax_utils
    from cdlnet_tpu_torch import utils

    rng = np.random.default_rng(0)
    a, b = rng.uniform(size=(2, 1, 3, 8, 8))
    assert utils.psnr(a, b) == jax_utils.psnr(a, b)
    assert utils.psnr(a, a) == jax_utils.psnr(a, a) == float("inf")
    f = rng.standard_normal((10, 3, 5, 5)).astype(np.float32)
    for kw in ({"normalize_each": True}, {"value_range": (-1, 1), "padding": 3}, {}):
        np.testing.assert_array_equal(utils.make_grid(f, nrow=4, **kw),
                                      jax_utils.make_grid(f, nrow=4, **kw))
    clip = rng.uniform(-0.1, 1.1, size=(3, 4, 6, 7)).astype(np.float32)  # (C, D, H, W)
    vdir = tmp_path / "video"
    vdir.mkdir()
    for j in range(clip.shape[1]):
        utils.img_save(str(vdir / f"{j:05d}.png"), clip[:, j])
    for name, save, arr in (("gray.png", "img_save", clip[:1, 0]),
                            ("rgb.png", "img_save", clip[:, 0]),
                            ("clip.gif", "save_gif", clip)):
        getattr(utils, save)(str(tmp_path / f"t_{name}"), arr)
        getattr(jax_utils, save)(str(tmp_path / f"j_{name}"), arr)
        assert (tmp_path / f"t_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes()
    for gray in (True, False):
        np.testing.assert_array_equal(utils.img_load(str(tmp_path / "t_rgb.png"), gray),
                                      jax_utils.img_load(str(tmp_path / "t_rgb.png"), gray))
        got = utils.load_video(str(vdir), gray)
        np.testing.assert_array_equal(got, jax_utils.load_video(str(vdir), gray))
        assert got.shape == (1, 1 if gray else 3, 4, 6, 7)
