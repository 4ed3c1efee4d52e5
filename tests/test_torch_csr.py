"""cdlnet_tpu_torch's frame-recurrent CSR path on the CPU against the JAX
package: the CSR proxes, lista2d_fused's CSR prox modes (the kernels' plain
versions) against the JAX whole-frame kernel (K5) and banded pair (K7) in
interpret mode, CDLNetCSR / CDLNetCSRf2 in every dispatch case and their
goldens, the two frame recurrences, the Denoiser on CSR models and the
params round trip."""

import functools
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu.compat import import_net_state
from cdlnet_tpu.core.ops import prox_csr as jax_prox_csr
from cdlnet_tpu.core.ops import prox_csr_f2 as jax_prox_csr_f2
from cdlnet_tpu.kernels.lista2d import lista2d_fused as jax_lista2d_fused
from cdlnet_tpu.kernels.lista2d_tiled import lista2d_tiled as jax_lista2d_tiled
from cdlnet_tpu.models import CDLNetCSR as JaxCDLNetCSR
from cdlnet_tpu.models import CDLNetCSRf2 as JaxCDLNetCSRf2
from cdlnet_tpu.models.csr import csr_video_denoise as jax_csr_video_denoise
from cdlnet_tpu.models.csr import csrf2_video_denoise as jax_csrf2_video_denoise
from cdlnet_tpu.serve import Denoiser as JaxDenoiser
from cdlnet_tpu_torch.compat.jax_params import export_jax_params, load_jax_params
from cdlnet_tpu_torch.core.ops import prox_csr, prox_csr_f2
from cdlnet_tpu_torch.kernels import lista2d as L2
from cdlnet_tpu_torch.kernels import lista3d as L
from cdlnet_tpu_torch.models import CDLNetCSR, CDLNetCSRf2, build_model
from cdlnet_tpu_torch.models.csr import csr_video_denoise, csrf2_video_denoise
from cdlnet_tpu_torch.serve import Denoiser


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FAMILIES = {"CDLNet_CSR": (JaxCDLNetCSR, CDLNetCSR),
            "CDLNet_CSRf2": (JaxCDLNetCSRf2, CDLNetCSRf2)}
CFG = dict(K=3, M=8, P=5, s=2, C=1, adaptive=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _j(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _t(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


def test_prox_csr_matches_jax_with_zeros_and_ties():
    """Exact zeros in u and z_prev (sign(0) = 0) and u on the shift."""
    rng = np.random.default_rng(0)
    u = rng.standard_normal((4, 5, 6)).astype(np.float32)
    zp = np.where(rng.uniform(size=u.shape) < 0.4, 0, rng.standard_normal(u.shape))
    zp = zp.astype(np.float32)
    u[0, 0] = 0.0
    lam = np.abs(rng.standard_normal((4, 5, 1))).astype(np.float32) * 0.3
    gam = np.abs(rng.standard_normal((4, 5, 1))).astype(np.float32)
    u[1] = zp[1] + lam[1] * np.sign(zp[1])  # u - shift == 0
    got = prox_csr(*map(torch.from_numpy, (u, zp, lam, gam)))
    want = jax_prox_csr(*map(jnp.asarray, (u, zp, lam, gam)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_prox_csr_f2_matches_jax_with_zeros_and_ties():
    """z_prev = z_after (the neighbour signs vanish), exact zeros and u on
    Ca, where the prox jumps."""
    rng = np.random.default_rng(1)
    shape = (4, 5, 6)
    f = lambda: rng.standard_normal(shape).astype(np.float32)
    u, zp, za = f(), f(), f()
    zp[0], za[0] = 0.0, 0.0
    za[1] = zp[1]
    lam = (0.3 * np.abs(rng.standard_normal((4, 5, 1)))).astype(np.float32)
    g1, g2 = (np.abs(rng.standard_normal((4, 5, 1))).astype(np.float32) for _ in range(2))
    Ca = zp + lam * np.sign(zp) + lam * g2 * np.sign(zp - za)
    u[2] = Ca[2]
    got = prox_csr_f2(*map(torch.from_numpy, (u, zp, za, lam, g1, g2)))
    want = jax_prox_csr_f2(*map(jnp.asarray, (u, zp, za, lam, g1, g2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("first", [False, True])
def test_csr_analyses_with_zero_neighbours_and_gammas_are_the_st_analysis(first):
    """prox_csr(v, 0; tau, 0) and prox_csr_f2(v, 0, 0; tau, 0, 0) are
    soft(v, tau): the CSR analyses' plain versions with zero neighbour codes
    and gamma banks give the ST analysis's codes bit for bit (the identity
    the kernels' shared mainloop is held to on the card), and the JAX
    proxes' on the same v within 1e-6."""
    rng = np.random.default_rng(3)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    N, M, P, s, H, W = 2, 8, 7, 2, 10, 13
    pads = ((P - 1) // 2,) * 2
    geom = L.Geom(s, (P, P), pads)
    wa = L2.prep_A2m_2d(torch.from_numpy(0.1 * f(1, M, 1, P, P)), s, pads)[0]
    r = torch.from_numpy(f(N, s * s, H, W))
    z = None if first else torch.from_numpy(f(N, M, H, W))
    tau = torch.from_numpy(rng.uniform(0.0, 0.5, (N, M)).astype(np.float32))
    codes, bank = torch.zeros(N, M, H, W), torch.zeros(N, M)
    st = L2.lista2d_ana_threshold_plain(r, z, wa, tau, geom)
    csr = L2.lista2d_ana_csr_plain(r, z, wa, tau, bank, codes, geom)
    csrf2 = L2.lista2d_ana_csrf2_plain(r, z, wa, tau, bank, bank, codes, codes, geom)
    assert torch.equal(csr, st) and torch.equal(csrf2, st)
    assert int((st != 0).sum()) > st.numel() // 4  # the threshold leaves codes
    v = jnp.asarray(L2.ana_argument_plain(r, z, wa, geom).numpy())
    zeros, lam = jnp.zeros(v.shape), jnp.asarray(tau.numpy()[:, :, None, None])
    nil = jnp.zeros(lam.shape)
    np.testing.assert_allclose(csr.numpy(), np.asarray(jax_prox_csr(v, zeros, lam, nil)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        csrf2.numpy(), np.asarray(jax_prox_csr_f2(v, zeros, zeros, lam, nil, nil)),
        rtol=0, atol=1e-6)


def _fused_inputs(H, W, seed=0):
    """K=3, M=8, P=7, s=2, N=2 with per-image sigma 20 and 30, positive
    thresholds and gamma banks, sparse neighbour codes."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    K, M, N = 3, 8, 2
    yp = 0.3 * f(N, 1, H, W)
    A, B = 0.1 * f(K, M, 1, 7, 7), 0.1 * f(K, M, 1, 7, 7)
    t = 0.02 * np.abs(f(K, 2, M, 1, 1))
    c = np.array([20 / 255, 30 / 255], np.float32).reshape(N, 1, 1, 1)
    zp = f(N, M, H // 2, W // 2)
    zp = np.where(np.abs(zp) < 0.5, 0, zp).astype(np.float32)
    za = 0.3 * f(N, M, H // 2, W // 2)
    g, g2 = 0.5 * np.abs(f(K, 2, M, 1, 1)), 0.5 * np.abs(f(K, 2, M, 1, 1))
    modes = {"z_prev": dict(g=g, z_prev=zp), "z_after": dict(g2=g2, z_after=za),
             "both": dict(g=g, g2=g2, z_prev=zp, z_after=za)}
    return (yp, A, B, t, c), modes


MODES = ["z_prev", "z_after", "both"]


@pytest.mark.parametrize("mode", MODES)
def test_fused_csr_modes_match_jax_pallas_interpret(mode):
    """K5's CSR modes (n_codes 1, 2, and z_after alone) at 32^2."""
    ops, modes = _fused_inputs(32, 32)
    kw = modes[mode]
    xj, zj = jax_lista2d_fused(*map(jnp.asarray, ops), stride=2, return_z=True,
                               interpret=True, **_j(kw))
    L.launches.clear()
    xt, zt = L2.lista2d_fused(*map(torch.from_numpy, ops), stride=2, return_z=True,
                              **_t(kw))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-5)
    assert sum(L.launches.values()) == 0  # the plain versions ran


@pytest.mark.parametrize("mode", MODES)
def test_fused_csr_modes_match_jax_tiled_interpret(mode):
    """K7's banded CSR analysis at 64x32 (two bands of 16 code rows), with
    fp32 codes."""
    ops, modes = _fused_inputs(64, 32, seed=2)
    kw = modes[mode]
    xj, zj = jax_lista2d_tiled(*map(jnp.asarray, ops), stride=2, return_z=True,
                               z_dtype=jnp.float32, interpret=True, band=16, **_j(kw))
    xt, zt = L2.lista2d_fused(*map(torch.from_numpy, ops), stride=2, return_z=True,
                              **_t(kw))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-5)


def test_fused_csr_mode_needs_its_gamma_bank_and_takes_no_history(monkeypatch):
    """A neighbour code needs its gamma bank; with return_hist a CSR mode
    returns the u history (the prox argument of every iteration) beside
    the z and r histories, fp32 (CDLNET_HIST_DTYPE=f32), the last u_k
    giving the returned codes."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")
    ops, modes = _fused_inputs(16, 16)
    args = map(torch.from_numpy, ops)
    with pytest.raises(ValueError, match="gamma bank"):
        L2.lista2d_fused(*args, stride=2, z_prev=torch.from_numpy(modes["both"]["z_prev"]))
    kw = _t(modes["both"])
    _, z, (z_hist, r_hist, u_hist) = L2.lista2d_fused(
        *map(torch.from_numpy, ops), stride=2, return_z=True, return_hist=True, **kw)
    K, M, N = 3, 8, 2
    assert u_hist.shape == z_hist.shape == (K, N, M, 8, 8) and u_hist.dtype == torch.float32
    assert r_hist.shape == (K - 1, N, 4, 8, 8)
    c = torch.from_numpy(ops[4])
    tau, g1, g2 = (L2.threshold_bank(b, c, N, z)[-1][:, :, None, None]
                   for b in (torch.from_numpy(ops[3]), kw["g"], kw["g2"]))
    torch.testing.assert_close(prox_csr_f2(u_hist[-1], kw["z_prev"], kw["z_after"], tau, g1, g2),
                               z, rtol=0, atol=0)


@functools.cache
def _params(family, seed=0):
    """JAX-initialized params (power method) with seeded positive
    thresholds and gamma banks; CDLNetCSR's first-frame banks are set to
    the primary ones, as parity runs set them (the reference's default
    init of A2/B2 is expansive). Cached: no test changes them."""
    jm = FAMILIES[family][0](**CFG)
    p = _np(jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name, v in p.items():
        if v.shape[1] == 2:  # t, t2, g, g1, g2
            scale = 0.05 if name.startswith("t") else 0.5
            p[name] = (scale * rng.uniform(size=v.shape)).astype(np.float32)
    if family == "CDLNet_CSR":
        p["A2"], p["B2"] = p["A"].copy(), p["B"].copy()
    return jm, p


def _port(family, params, backend):
    return load_jax_params(FAMILIES[family][1](**CFG, backend=backend), params)


def _codes(M, seed, N=2, hw=(10, 9)):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((N, M, *hw)).astype(np.float32)
    return np.where(np.abs(z) < 0.6, 0, z).astype(np.float32)


# (family, neighbour codes given): every dispatch case of both models
CASES = [("CDLNet_CSR", ()), ("CDLNet_CSR", ("z_prev",)),
         ("CDLNet_CSRf2", ()), ("CDLNet_CSRf2", ("z_prev",)),
         ("CDLNet_CSRf2", ("z_after",)), ("CDLNet_CSRf2", ("z_prev", "z_after"))]


@pytest.mark.parametrize("backend", ["xla", "cuda"])
@pytest.mark.parametrize("family,given", CASES)
def test_model_dispatch_matches_jax(family, given, backend):
    """Each dispatch case on the plain loop ("xla") and on the kernels'
    plain versions ("cuda" on CPU tensors) against JAX's "xla", on an odd
    19x18 frame pair with per-image sigma."""
    jm, params = _params(family)
    rng = np.random.default_rng(3)
    y = rng.uniform(size=(2, 1, 19, 18)).astype(np.float32)
    sigma = np.array([20.0, 30.0], np.float32)
    codes = {name: _codes(CFG["M"], 5 + i) for i, name in enumerate(given)}
    xj, zj = jm.apply(params, jnp.asarray(y), sigma=jnp.asarray(sigma), **_j(codes))
    model = _port(family, params, backend)
    with torch.no_grad():
        xt, zt = model(torch.from_numpy(y), sigma=torch.from_numpy(sigma), **_t(codes))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-5)


def _golden(name):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    sd = {k[4:]: data[k] for k in data.files if k.startswith("sd::")}
    return sd, {k: data[k] for k in data.files if not k.startswith("sd::")}


def _check(ours, golden):
    np.testing.assert_allclose(ours.numpy(), golden, rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_csr_golden(backend):
    """The reference torch forward (tests/test_models_golden.py's csr case),
    the state dict mapped by the JAX package's importer."""
    sd, g = _golden("csr")
    cfg = dict(K=3, M=6, P=5, s=2, C=1, adaptive=True)
    model = load_jax_params(CDLNetCSR(**cfg, backend=backend),
                            _np(import_net_state(JaxCDLNetCSR(**cfg), sd)))
    x, s = torch.from_numpy(g["x"]), float(g["sigma"])
    with torch.no_grad():
        xhat0, z0 = model(x, None, s)
        xhat1, z1 = model(x, torch.from_numpy(g["z0"]), s)
    for ours, name in ((xhat0, "xhat0"), (z0, "z0"), (xhat1, "xhat1"), (z1, "z1")):
        _check(ours, g[name])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_csrf2_golden(backend):
    sd, g = _golden("csrf2")
    cfg = dict(K=3, M=6, P=5, s=2, C=1, adaptive=True)
    model = load_jax_params(CDLNetCSRf2(**cfg, backend=backend),
                            _np(import_net_state(JaxCDLNetCSRf2(**cfg), sd)))
    x, s = torch.from_numpy(g["x"]), float(g["sigma"])
    zn, zo = torch.from_numpy(g["z_none"]), torch.from_numpy(g["z_prev_other"])
    with torch.no_grad():
        xh_none, z_none = model(x, None, None, s)
        xh_prev, _ = model(x, zn, None, s)
        xh_after, _ = model(x, None, zn, s)
        xh_both, _ = model(x, zn, zo, s)
    for ours, name in ((xh_none, "xh_none"), (z_none, "z_none"), (xh_prev, "xh_prev"),
                       (xh_after, "xh_after"), (xh_both, "xh_both")):
        _check(ours, g[name])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_video_denoise_matches_jax(family):
    """The recurrences on two 4-frame 32^2 clips with one sigma per clip,
    on the kernels' plain versions: CSRf2's pass 2 is one batched forward
    here and a vmap in JAX."""
    jm, params = _params(family, seed=1)
    rng = np.random.default_rng(4)
    clip = rng.uniform(size=(2, 1, 4, 32, 32)).astype(np.float32)
    sigma = np.array([20.0, 30.0], np.float32)
    jrec = jax_csr_video_denoise if family == "CDLNet_CSR" else jax_csrf2_video_denoise
    rec = csr_video_denoise if family == "CDLNet_CSR" else csrf2_video_denoise
    xj, zj = jrec(jm, params, jnp.asarray(clip), jnp.asarray(sigma.reshape(2, 1, 1, 1)))
    model = _port(family, params, "cuda")
    with torch.no_grad():
        xt, zt = rec(model, torch.from_numpy(clip), torch.from_numpy(sigma))
    assert xt.shape == clip.shape
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-5)


@pytest.mark.parametrize("blind", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_denoiser_matches_jax(family, blind):
    """Denoiser on CSR models (tests/test_serve.py's CSR case): a 4-frame
    20x20 clip by the recurrence and a frame with no neighbour code, known
    sigma and blind (one MAD estimate per call), bucketed to 32."""
    jm, params = _params(family, seed=2)
    rng = np.random.default_rng(6)
    clip = rng.uniform(0, 1, (4, 20, 20)).astype(np.float32)
    sigma = None if blind else 25
    jd = JaxDenoiser(jm, params, bucket=32)
    d = Denoiser(_port(family, params, "cuda"), bucket=32)
    np.testing.assert_allclose(d.denoise_video(clip, sigma=sigma),
                               jd.denoise_video(clip, sigma=sigma), atol=1e-5)
    np.testing.assert_allclose(d.denoise_image(clip[0], sigma=sigma),
                               jd.denoise_image(clip[0], sigma=sigma), atol=1e-5)


def test_denoiser_csr_runs_whole_clips_only():
    """chunk_depth below the depth and tile_hw raise (they fail in the JAX
    package's Denoiser too); chunk_depth at the depth runs the clip."""
    _, params = _params("CDLNet_CSR")
    d = Denoiser(_port("CDLNet_CSR", params, "cuda"), bucket=16)
    clip = np.random.default_rng(7).uniform(size=(4, 16, 16)).astype(np.float32)
    for kw in (dict(chunk_depth=2), dict(tile_hw=8)):
        with pytest.raises(TypeError, match="whole clips"):
            d.denoise_video(clip, sigma=25, **kw)
    np.testing.assert_array_equal(d.denoise_video(clip, sigma=25, chunk_depth=4),
                                  d.denoise_video(clip, sigma=25))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_params_round_trip_and_init(family):
    """JAX params -> the port -> JAX params, every name and value; the
    port's own init has the JAX params' names, shapes and projection."""
    jm, params = _params(family)
    model = _port(family, params, "xla")
    back = export_jax_params(model)
    assert back.keys() == params.keys()
    for name in params:
        np.testing.assert_array_equal(back[name], params[name])
    own = build_model(family, dict(CFG, t0=0.1)).init(torch.Generator().manual_seed(0))
    want = jm.init(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in export_jax_params(own).items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(float(v.min()) == float(v.max()) == pytest.approx(0.1)
               for k, v in export_jax_params(own).items() if k[0] in "tg")
    with torch.no_grad():
        own.A.mul_(10.0)
        own.t.sub_(1.0)
    own.project()
    with torch.no_grad():
        assert float(own.t.min()) == 0.0
        assert float(own.A.flatten(3).norm(dim=3).max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("family", list(FAMILIES))
def test_grad_enabled_kernel_forward_raises(family, monkeypatch):
    """Under autograd the kernel backend trains (the test's name is from
    before CSR training was ported): its gradients, through the kernels'
    plain versions and the CSR reverse loop over fp32 histories
    (CDLNET_HIST_DTYPE=f32), equal backend "xla"'s torch autograd, for
    every parameter and the carried neighbour code."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")
    _, params = _params(family)
    rng = np.random.default_rng(6)
    y = torch.from_numpy(rng.uniform(size=(1, 1, 16, 16)).astype(np.float32))
    zp = torch.from_numpy(_codes(8, 7, N=1, hw=(8, 8)))
    grads = {}
    for backend in ("cuda", "xla"):
        model = _port(family, params, backend)
        code = zp.clone().requires_grad_()
        x0, z0 = model(y, sigma=25.0)  # a first frame: no code
        xhat, z = model(y, code, sigma=25.0)
        loss = (x0 ** 2).mean() + (xhat ** 2).mean() + 0.1 * (z ** 2).mean()
        names = [n for n, _ in model.named_parameters()]
        grads[backend] = dict(zip(names + ["z_prev"], torch.autograd.grad(
            loss, [p for _, p in model.named_parameters()] + [code], allow_unused=True)))
    assert [n for n, g in grads["xla"].items() if g is None] == \
        ([] if family == "CDLNet_CSR" else ["g2"])  # CSRf2's g2 needs z_after
    for name, want in grads["xla"].items():
        got = grads["cuda"][name]
        if want is None:
            assert got is None, name
            continue
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-9, name
