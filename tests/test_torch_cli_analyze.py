"""The port's 2D analysis CLI (cli/analyze.py) and the 2D models'
apply_with_codes on the CPU, against the JAX package's.

The two CLIs draw their noise from different generators, so the
comparisons of their files feed both the same noise: each package's awgn is
replaced by one that adds seeded numpy noise. The CLIs then run the trained
2D demos on the same images, and their txt, metrics rows and PNG names must
agree; the txt byte for byte."""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu.cli import analyze as jax_analyze
from cdlnet_tpu.models import CDLNet as JaxCDLNet
from cdlnet_tpu.models import CDLNetCSR as JaxCDLNetCSR
from cdlnet_tpu.models import CDLNetCSRf2 as JaxCDLNetCSRf2
from cdlnet_tpu.models import GDLNet as JaxGDLNet
from cdlnet_tpu_torch.cli import analyze
from cdlnet_tpu_torch.compat.jax_params import load_jax_params
from cdlnet_tpu_torch.data.synthetic import gen_synthetic_image_dirs
from cdlnet_tpu_torch.kernels import lista3d as L
from cdlnet_tpu_torch.models import CDLNet, CDLNetCSR, CDLNetCSRf2, GDLNet

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = os.path.join(ROOT, "examples")


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
def image_dirs(tmp_path_factory):
    """Two 128x128 images per split, written by the port (the demos were
    trained on 128^2 crops; on 64^2 fields their borders cost more than
    they denoise)."""
    return gen_synthetic_image_dirs(str(tmp_path_factory.mktemp("imgs")), n_images=2,
                                    size=128)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_params(jax_model, seed):
    """Power-method params with seeded positive thresholds."""
    p = _np(jax_model.init(jax.random.PRNGKey(seed)))
    p["t"] = (0.05 * np.random.default_rng(seed).uniform(size=p["t"].shape)).astype(np.float32)
    return p


MODELS = {
    "CDLNet": (JaxCDLNet, CDLNet, dict(K=3, M=8, P=5, s=2, C=1, adaptive=True)),
    "GDLNet": (JaxGDLNet, GDLNet, dict(K=3, M=6, P=5, s=2, C=1, order=2, adaptive=True,
                                       shared="a_,w0")),
}


@pytest.mark.parametrize("backend", ["xla", "cuda"])
@pytest.mark.parametrize("family", list(MODELS))
def test_apply_with_codes_matches_jax(family, backend):
    """Every iteration's codes, the final code and the output, with
    per-image sigma; on "cuda" (the kernels' plain versions here) the codes
    are the loop's fp32 z histories."""
    jax_cls, cls, cfg = MODELS[family]
    jm = jax_cls(**cfg)
    params = _random_params(jm, 1)
    y = np.random.default_rng(2).uniform(size=(2, 1, 24, 22)).astype(np.float32)
    sigma = np.array([15.0, 30.0], np.float32)
    want = jm.apply_with_codes(params, jnp.asarray(y), jnp.asarray(sigma))
    model = load_jax_params(cls(**cfg, backend=backend), params)
    L.launches.clear()
    with torch.inference_mode():
        got = model.apply_with_codes(torch.from_numpy(y), torch.from_numpy(sigma))
    assert got[2].shape == (3, 2, cfg["M"], 12, 11)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    torch.testing.assert_close(got[2][-1], got[1], rtol=0, atol=0)
    assert sum(L.launches.values()) == 0


def _numpy_noise(shape, sigma):
    rng = np.random.default_rng(int(sigma) * 1000 + int(np.prod(shape)) % 997)
    return (float(sigma) / 255.0 * rng.standard_normal(shape)).astype(np.float32)


def _jax_awgn(key, x, sigma):
    return x + jnp.asarray(_numpy_noise(x.shape, sigma)), jnp.asarray(sigma, jnp.float32)


def _torch_awgn(x, sigma, generator=None):
    noise = torch.from_numpy(_numpy_noise(tuple(x.shape), sigma)).to(x.device)
    return x + noise, torch.as_tensor(sigma, dtype=x.dtype, device=x.device)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _rows(save):
    with open(os.path.join(save, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(x).items() if k != "ts"} for x in f if x.strip()]


def _demo_args(demo, save):
    with open(os.path.join(EXAMPLES, demo, "args.json")) as f:
        args = json.load(f)
    args["paths"] = {"save": save, "ckpt": os.path.join(EXAMPLES, demo, "net.ckpt.npz")}
    return args


FLAGS = ["--noise_level", "15", "25", "--save", "--dictionary", "--filters", "--thresholds"]


@pytest.mark.parametrize("demo,extra", [("cdlnet-demo", []), ("gdlnet-demo", []),
                                        ("jdd-demo", ["--color", "--demosaic"]),
                                        ("cdlnet-demo", ["--blind", "MAD"])])
def test_cli_writes_the_jax_clis_files(image_dirs, tmp_path, monkeypatch, demo, extra):
    """Both CLIs on the same images, weights and noise: the same txt bytes,
    eval rows, PNG names and passthrough PSNR (JDD with colour and a Bayer
    mask; blind MAD)."""
    import cdlnet_tpu.data.noise as jax_noise

    monkeypatch.setattr(jax_noise, "awgn", _jax_awgn)
    monkeypatch.setattr(analyze, "awgn", _torch_awgn)
    test_dir = os.path.join(image_dirs, "test")
    img = os.path.join(test_dir, "img001.png")
    argv = ["args.json", "--test", test_dir, "--passthrough", img, *FLAGS, *extra]
    jsave, tsave = str(tmp_path / "jax"), str(tmp_path / "torch")
    out = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: out.append(" ".join(map(str, a))))
    jax_analyze.main(jax_analyze.build_argparser().parse_args(argv + ["--backend", "xla"]),
                     _demo_args(demo, jsave))
    analyze.main(analyze.build_argparser().parse_args(argv), _demo_args(demo, tsave),
                 device="cpu")
    monkeypatch.undo()
    jp, tp = (ln for ln in out if ln.startswith("PSNR = "))  # the passthroughs'

    blind = "MAD" if "--blind" in extra else None
    name = f"test_test_{blind}.txt"
    with open(os.path.join(jsave, name), "rb") as a, open(os.path.join(tsave, name),
                                                          "rb") as b:
        txt = b.read()
        assert a.read() == txt
    lines = txt.decode().splitlines()
    assert [ln.split(", ")[0] for ln in lines] == ["15", "25"]
    for jr, tr in zip(_rows(jsave), _rows(tsave)):
        assert tr.keys() == jr.keys() and tr["images"] == jr["images"] == 2
        assert abs(tr["psnr"] - jr["psnr"]) < 1e-3 and tr["blind"] == str(blind)
    assert _files(tsave) == _files(jsave)
    K = _demo_args(demo, "")["model"]["K"]
    assert {"tau.png", "D_learned.png", "freq.png", "test_output/output_00002.png",
            f"filters/AB{K - 1:02d}_True.png", f"filters/D{K - 1:02d}_True.png",
            "passthrough_img001/compare.png", f"passthrough_img001/csc{K - 1:02d}.png"} \
        <= set(_files(tsave))
    assert tp == jp and float(tp.split()[-1]) > 25  # the noisy input is ~20.2 dB


def test_cli_defaults_and_pca(image_dirs, tmp_path):
    """The noise level defaults to the config's; the CLI's own noise on the
    kernels' plain versions beats the noisy input, with --blind PCA too."""
    args = _demo_args("cdlnet-demo", str(tmp_path))
    args["train"]["fit"]["noise_std"] = 25
    test_dir = os.path.join(image_dirs, "test")
    analyze.main(analyze.build_argparser().parse_args(["args.json", "--test", test_dir]),
                 args, device="cpu")
    (line,) = open(tmp_path / "test_test_None.txt").read().splitlines()
    sigma, p = line.split(", ")
    assert sigma == "25" and 25.0 < float(p) < 60.0  # the noisy input is ~20.2 dB
    analyze.main(analyze.build_argparser().parse_args(
        ["args.json", "--test", test_dir, "--blind", "PCA"]), args, device="cpu")
    (line,) = open(tmp_path / "test_test_PCA.txt").read().splitlines()
    sigma, p = line.split(", ")
    assert sigma == "25" and 25.0 < float(p) < 60.0


@pytest.mark.parametrize("jax_cls,cls", [(JaxCDLNetCSR, CDLNetCSR),
                                         (JaxCDLNetCSRf2, CDLNetCSRf2)])
def test_filters_of_csr_banks_match_jax(tmp_path, jax_cls, cls):
    """get_filters_for takes the CSR models' primary banks; the filter
    grids and dictionary it draws are the JAX CLI's files, byte for byte."""
    cfg = dict(K=3, M=8, P=5, s=2, C=1, adaptive=True)
    jm = jax_cls(**cfg)
    params = _np(jm.init(jax.random.PRNGKey(3)))
    model = load_jax_params(cls(**cfg), params)
    for got, want in zip(analyze.get_filters_for(model),
                         jax_analyze.get_filters_for(jm, params)):
        np.testing.assert_array_equal(got, np.asarray(want))
    jsave, tsave = tmp_path / "jax", tmp_path / "torch"
    for d in (jsave, tsave):
        d.mkdir()
    jax_analyze.filters(jm, params, str(jsave))
    jax_analyze.dictionary(jm, params, str(jsave))
    analyze.filters(model, str(tsave))
    analyze.dictionary(model, str(tsave))
    assert _files(str(tsave)) == _files(str(jsave))
    for f in _files(str(tsave)):
        assert (tsave / f).read_bytes() == (jsave / f).read_bytes(), f
