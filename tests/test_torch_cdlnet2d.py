"""cdlnet_tpu_torch's 2D models (CDLNet, JDD, GDLNet), Gabor banks, MAD
noise estimator and image Denoiser against the reference goldens and the
JAX package."""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu.compat import import_net_state
from cdlnet_tpu.core.gabor import gabor_kernel as jax_gabor_kernel
from cdlnet_tpu.data.noise import gen_bayer_mask as jax_gen_bayer_mask
from cdlnet_tpu.models import CDLNet as JaxCDLNet
from cdlnet_tpu.models import GDLNet as JaxGDLNet
from cdlnet_tpu.nle import nle_mad as jax_nle_mad
from cdlnet_tpu.serve import Denoiser as JaxDenoiser
from cdlnet_tpu.train.checkpoint import load_ckpt
from cdlnet_tpu_torch.compat.jax_params import export_jax_params, load_jax_params
from cdlnet_tpu_torch.core.gabor import gabor_kernel
from cdlnet_tpu_torch.data.noise import awgn, gen_bayer_mask
from cdlnet_tpu_torch.models import CDLNet, GDLNet, build_model
from cdlnet_tpu_torch.nle import nle_mad, noise_level
from cdlnet_tpu_torch.serve import Denoiser
from cdlnet_tpu_torch.train.checkpoint import load_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "tests", "golden")
EXAMPLES = os.path.join(ROOT, "examples")
FLAGSHIP = os.path.join(EXAMPLES, "cdlnet-flagship-demo")
JDD = os.path.join(EXAMPLES, "jdd-demo")

# name -> (JAX model, port model class, its config); the goldens' configs
# as tests/test_models_golden.py builds them
GOLDENS = {
    "cdlnet2d": (JaxCDLNet, CDLNet, dict(K=4, M=8, P=5, s=2, C=1, adaptive=True)),
    "cdlnet_jdd": (JaxCDLNet, CDLNet, dict(K=3, M=6, P=7, s=1, C=3, adaptive=True)),
    "gdlnet": (JaxGDLNet, GDLNet, dict(K=3, M=6, P=5, s=2, C=1, order=2,
                                       adaptive=True, shared="")),
    "gdlnet_shared": (JaxGDLNet, GDLNet, dict(K=3, M=6, P=5, s=2, C=1, order=2,
                                              adaptive=True, shared="alpha_a_w0_psi")),
}


def _golden(name):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    sd = {k[4:]: data[k] for k in data.files if k.startswith("sd::")}
    return sd, {k: data[k] for k in data.files if not k.startswith("sd::")}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(GOLDENS))
def test_golden(name, backend):
    """The reference torch forward, with the state dict mapped to params by
    the JAX package's importer, held at the JAX golden tolerance."""
    sd, g = _golden(name)
    jax_cls, cls, cfg = GOLDENS[name]
    model = load_jax_params(cls(**cfg, backend=backend),
                            _np(import_net_state(jax_cls(**cfg), sd)))
    sigma = torch.from_numpy(g["sigma"]) if g["sigma"].ndim else float(g["sigma"])
    mask = torch.from_numpy(g["mask"]) if "mask" in g else None
    with torch.no_grad():
        xhat, z = model(torch.from_numpy(g["x"]), sigma, mask=mask, return_z=True)
    np.testing.assert_allclose(xhat.numpy(), g["xhat"], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(z.numpy(), g["z"], rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("shared", ["", "a_,w0", "alpha_a_w0_psi"])
def test_gabor_banks_match_jax(shared):
    cfg = dict(K=3, M=5, P=7, s=2, C=2, order=2, adaptive=True, shared=shared)
    jm = JaxGDLNet(**cfg)
    params = jm.init(jax.random.PRNGKey(1), init=False)
    tm = load_jax_params(GDLNet(**cfg), _np(params))
    with torch.no_grad():
        got = tm.get_filters()
    for g, w in zip(got, jm.get_filters(params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    rng = np.random.default_rng(0)
    a, w0 = (rng.standard_normal((2, 3, 1, 2)).astype(np.float32) for _ in range(2))
    psi = rng.standard_normal((2, 3, 1)).astype(np.float32)
    np.testing.assert_allclose(
        gabor_kernel(*map(torch.from_numpy, (a, w0, psi)), 5).numpy(),
        np.asarray(jax_gabor_kernel(*map(jnp.asarray, (a, w0, psi)), 5)), atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 1, 30, 28), (1, 1, 30, 30), (1, 3, 31, 33)])
def test_nle_mad_matches_jax(shape):
    """HH of a 30x28 image holds 11x10 values (an even count: the median
    averages the two middle ones), of a 30x30 one 11x11 (odd)."""
    y = np.random.default_rng(2).uniform(size=shape).astype(np.float32)
    want = np.asarray(jax_nle_mad(jnp.asarray(y)))
    got = nle_mad(torch.from_numpy(y))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert torch.equal(noise_level(torch.from_numpy(y), method=True), got)
    # PCA (held to JAX in tests/test_torch_nle_pca.py): one estimate an image too
    assert noise_level(torch.from_numpy(y), method="PCA").shape == want.shape


@pytest.mark.parametrize("family", ["CDLNet", "GDLNet"])
def test_project_matches_jax(family):
    if family == "CDLNet":
        cfg = dict(K=2, M=4, P=5, s=2, C=1)
        jm, tm = JaxCDLNet(**cfg), CDLNet(**cfg)
    else:
        cfg = dict(K=2, M=4, P=5, s=2, C=1, order=2, shared="a_,w0")
        jm, tm = JaxGDLNet(**cfg), GDLNet(**cfg)
    params = _np(jm.init(jax.random.PRNGKey(0), init=False))
    rng = np.random.default_rng(3)
    params = {k: (3.0 * v if k in ("A", "B") else v) for k, v in params.items()}
    params["t"] = rng.standard_normal(params["t"].shape).astype(np.float32)
    want = jm.project(jax.tree_util.tree_map(jnp.asarray, params))
    got = export_jax_params(load_jax_params(tm, params).project())
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-6)


@pytest.mark.parametrize("demo,cls", [("cdlnet-flagship-demo", CDLNet),
                                      ("cdlnet-demo", CDLNet), ("jdd-demo", CDLNet),
                                      ("gdlnet-demo", GDLNet)])
def test_demo_checkpoints_load_like_jax(demo, cls):
    """The four 2D demo bundles ('p::' keys, g and GDLNet's flat names
    included) load into the port as into the JAX package."""
    with open(os.path.join(EXAMPLES, demo, "args.json")) as f:
        args = json.load(f)
    model = build_model(args["type"], args["model"])
    assert type(model) is cls
    ck = os.path.join(EXAMPLES, demo, "net.ckpt.npz")
    params, _ = load_params(ck)
    jax_model = {"CDLNet": JaxCDLNet, "GDLNet": JaxGDLNet}[cls.__name__](
        **{k: v for k, v in args["model"].items() if k not in ("init", "backend")})
    jparams, _, _, _ = load_ckpt(ck, jax_model.init(jax.random.PRNGKey(0), init=False))
    back = export_jax_params(load_jax_params(model, params))
    assert sorted(back) == sorted(jparams)
    for k in back:
        np.testing.assert_array_equal(back[k], np.asarray(jparams[k]))


def _smooth_image(shape, seed=0):
    yy, xx = np.meshgrid(*(np.linspace(-np.pi, np.pi, n) for n in shape), indexing="ij")
    clean = (0.5 + 0.3 * np.sin(2 * xx + 1) * np.cos(1.5 * yy)).astype(np.float32)
    rng = np.random.default_rng(seed)
    return clean, (clean + 25 / 255 * rng.standard_normal(shape)).astype(np.float32)


def test_flagship_demo_denoiser_matches_jax():
    """The flagship demo (K=30, M=169) on an odd-size image, bucketed to
    64x64: known sigma and blind (MAD after the bucket pad) against the JAX
    Denoiser on backend "xla"."""
    _, noisy = _smooth_image((45, 47))
    ours = Denoiser.from_dir(FLAGSHIP, device="cpu")
    theirs = JaxDenoiser.from_dir(FLAGSHIP, backend="xla")
    for sigma in (25, None):
        got = ours.denoise_image(noisy, sigma=sigma)
        assert got.shape == noisy.shape
        np.testing.assert_allclose(got, np.asarray(theirs.denoise_image(noisy, sigma=sigma)),
                                   atol=1e-4)


def test_denoise_image_batch_per_image_sigma_and_warmup():
    model = CDLNet(K=2, M=4, P=5, s=2, adaptive=True, backend="pallas").init(
        torch.Generator().manual_seed(0), init=False)
    with torch.no_grad():  # contractive banks without the power method
        model.A.mul_(0.1)
        model.B.mul_(0.1)
        model.t.fill_(0.02)
    d = Denoiser(model, bucket=16)
    d.warmup([(20, 12)])
    imgs = np.random.default_rng(4).uniform(size=(2, 20, 12)).astype(np.float32)
    both = d.denoise_image_batch(list(imgs), sigmas=[10.0, 40.0])
    assert both.shape == imgs.shape
    for i, s in enumerate((10.0, 40.0)):
        np.testing.assert_allclose(both[i], d.denoise_image(imgs[i], sigma=s), atol=1e-5)
    blind = d.denoise_image_batch(imgs)
    est = 255 * nle_mad(torch.from_numpy(np.pad(imgs, [(0, 0), (0, 12), (0, 4)],
                                                mode="reflect")[:, None])).reshape(-1)
    np.testing.assert_allclose(blind, d.denoise_image_batch(imgs, sigmas=list(est.numpy())),
                               atol=1e-6)
    with pytest.raises(ValueError):
        d.denoise_image_batch(imgs, sigmas=[10.0, 20.0, 30.0])


def test_video_blind_sigma_is_the_framewise_mean():
    """Blind clips: 255 * the mean over frames of the MAD estimate per
    clip, as the JAX Denoiser's _blind_forward forms it."""
    d = Denoiser.from_dir(os.path.join(EXAMPLES, "cdlnet-video-demo"), device="cpu")
    clips = np.random.default_rng(5).uniform(size=(2, 1, 4, 24, 20)).astype(np.float32)
    padded = np.pad(clips, [(0, 0)] * 3 + [(0, 40), (0, 44)], mode="reflect")
    frames = np.moveaxis(padded, 2, 1).reshape(8, 1, 64, 64)
    want = 255 * np.asarray(jax_nle_mad(jnp.asarray(frames))).reshape(2, 4).mean(axis=1)
    est = d._blind_sigma(torch.from_numpy(padded))
    np.testing.assert_allclose(est.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(d.denoise_video(clips), d.denoise_video(clips, sigma=want),
                               atol=1e-5)


def test_jdd_demo_with_bayer_mask_matches_jax():
    with open(os.path.join(JDD, "args.json")) as f:
        cfg = {k: v for k, v in json.load(f)["model"].items() if k != "init"}
    params, _ = load_params(os.path.join(JDD, "net.ckpt.npz"))
    clean = np.random.default_rng(6).uniform(size=(2, 3, 22, 18)).astype(np.float32)
    mask = gen_bayer_mask(torch.from_numpy(clean))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jax_gen_bayer_mask(jnp.asarray(clean))))
    noisy, _ = awgn(torch.from_numpy(clean), 10.0, torch.Generator().manual_seed(0))
    y = (mask * noisy).numpy()
    sigma = np.array([5.0, 15.0], np.float32)
    xj, _ = JaxCDLNet(**cfg).apply(jax.tree_util.tree_map(jnp.asarray, params),
                                   jnp.asarray(y), jnp.asarray(sigma), mask=jnp.asarray(mask))
    for backend in ("xla", "pallas"):
        model = load_jax_params(CDLNet(**dict(cfg, backend=backend)), params)
        with torch.no_grad():
            xt, _ = model(torch.from_numpy(y), torch.from_numpy(sigma), mask=mask)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)


@pytest.mark.parametrize("cls", [CDLNet, GDLNet])
def test_grad_enabled_kernel_forward_raises(cls):
    """A grad-enabled kernel forward that asks for the codes raises (the
    codes have no gradient); without them it trains, with backend "xla"'s
    output and gradients (the kernels' reverse loop, 1e-4 relative)."""
    model = cls(K=2, M=4, P=5, s=2, backend="pallas").init(torch.Generator().manual_seed(0))
    y = torch.rand(1, 1, 12, 12, generator=torch.Generator().manual_seed(1))
    with pytest.raises(NotImplementedError, match="return_z"):
        model(y, 25.0, return_z=True)
    x_k, _ = model(y, 25.0)
    grads_k = torch.autograd.grad(x_k.sum(), model.t)
    with torch.no_grad():
        x_nograd, _ = model(y, 25.0)
    model.backend = "xla"
    x, _ = model(y, 25.0)
    grads = torch.autograd.grad(x.sum(), model.t)
    torch.testing.assert_close(x_k.detach(), x_nograd, rtol=0, atol=0)
    torch.testing.assert_close(x.detach(), x_k.detach(), rtol=1e-4, atol=1e-5)
    assert float((grads_k[0] - grads[0]).abs().max() / grads[0].abs().max()) <= 1e-4


def test_image_denoiser_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Denoiser.from_dir(JDD)
    assert Denoiser.from_dir(JDD, device="cpu").device.type == "cpu"
