"""The training path of cdlnet_tpu_torch on the CPU, at tiny shapes, against
its own definitions and the JAX package: the reverse kernels' plain
versions, the reverse loop (XLA scan, and the TPU reverse kernels K2/K4 in
interpret mode), model gradients, the optimizer, a 30-step trajectory,
checkpoints in both directions, and fit()'s logs and backtracking.

Inputs and noise come from numpy seeds and go to both packages. All
comparisons are fp32; each tolerance is stated where it is used."""

import json
import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu.kernels.lista3d import lista3d_fused as jax_lista3d_fused
from cdlnet_tpu.kernels.lista3d_bwd import lista3d_fused_bwd as jax_k4_bwd
from cdlnet_tpu.kernels.lista3d_bwd_resident import (
    lista3d_fused_bwd_resident as jax_k2_bwd,
)
from cdlnet_tpu.models import CDLNetVideo as JaxCDLNetVideo
from cdlnet_tpu.ops.conv import conv_transpose3d as jax_conv_transpose3d
from cdlnet_tpu.ops.lista import lista_3d as jax_lista_3d
from cdlnet_tpu.train import checkpoint as jax_ckpt
from cdlnet_tpu.train.losses import mse_loss as jax_mse_loss
from cdlnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from cdlnet_tpu_torch.compat.jax_params import export_jax_params, load_jax_params
from cdlnet_tpu_torch.data.noise import awgn3d, gen_bayer_mask3d
from cdlnet_tpu_torch.kernels import lista3d as L
from cdlnet_tpu_torch.kernels import lista3d_bwd as LB
from cdlnet_tpu_torch.kernels.autodiff import lista3d_fused_diff
from cdlnet_tpu_torch.models import CDLNetVideo
from cdlnet_tpu_torch.train.checkpoint import load_ckpt, save_ckpt
from cdlnet_tpu_torch.train.fit import fit, init_model, make_train_step, train_update
from cdlnet_tpu_torch.train.losses import mse_loss, psnr_from_mse
from cdlnet_tpu_torch.train.optim import get_lr, make_optimizer, set_lr, steplr_value


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
DEMO = os.path.join(ROOT, "examples", "cdlnet-video-demo")
SHAPE = (2, 1, 8, 16, 16)
GEOMS = [((7, 7, 5), 2), ((5, 5, 3), 2), ((5, 5, 3), 1)]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(P, K=3, M=13, seed=0, shape=SHAPE):
    """Seeded numpy inputs shared by both packages; c differs per sample."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return dict(
        yp=0.3 * f(*shape), A=0.1 * f(K, M, shape[1], *P),
        B=0.1 * f(K, M, shape[1], *P), t=0.02 * np.abs(f(K, 2, M, 1, 1, 1)),
        c=np.array([0.1, 0.2], np.float32).reshape(2, 1, 1, 1, 1),
        mask=(rng.uniform(size=shape) > 0.5).astype(np.float32),
        tgt=rng.uniform(size=shape).astype(np.float32))


def _port_grads(d, s, use_mask, dx=None):
    """The port's gradients of mean((x - tgt)^2) (or of x against the
    cotangent dx) through lista3d_fused_diff: (loss, dA, dB, dt)."""
    A, B, t = (torch.from_numpy(d[k]).requires_grad_() for k in "ABt")
    x = lista3d_fused_diff(torch.from_numpy(d["yp"]), A, B, t, torch.from_numpy(d["c"]),
                           stride=s, mask=torch.from_numpy(d["mask"]) if use_mask else None)
    if dx is None:
        loss = torch.mean((x - torch.from_numpy(d["tgt"])) ** 2)
        grads = torch.autograd.grad(loss, (A, B, t))
        return (float(loss.detach()), *(g.numpy() for g in grads))
    return (None, *(g.numpy() for g in torch.autograd.grad(x, (A, B, t),
                                                           torch.tensor(dx))))


# --- (1) each reverse plain version against its definition, the VJP of the
# forward plain functions (tolerance 1e-5 relative: fp32 sums of <= 1.5k
# terms taken in another order) ---

def _phase_setup(P, s, seed=0):
    d = _inputs(P, seed=seed)
    pads = tuple(p // 2 for p in P)
    geom = L.Geom(s, P, pads)
    wa = L.prep_A2m_3d(torch.from_numpy(d["A"]), s, pads)[1]
    ws = L.prep_B2m_3d(torch.from_numpy(d["B"]), s, pads)[1]
    rng = np.random.default_rng(seed + 1)
    grid = [n // s for n in SHAPE[2:]]
    f = lambda ch: torch.from_numpy(rng.standard_normal((2, ch, *grid)).astype(np.float32))
    Cp, M = wa.shape[0], wa.shape[-1]
    z = f(M)
    z = torch.where(z.abs() < 0.5, torch.zeros_like(z), z)  # sparse codes
    return geom, wa, ws, z, f(Cp), f(M), f(Cp), f(M)


@pytest.mark.parametrize("P,s", GEOMS)
def test_wgrad_plain_is_the_bank_vjp(P, s):
    geom, wa, ws, z, r, dv, g, _ = _phase_setup(P, s)
    taps = tuple(wa.shape[1:4])
    for x, w, off, cot in ((r, wa, geom.off_a, dv), (z, ws, geom.off_s, g)):
        w = w.clone().requires_grad_()
        want, = torch.autograd.grad(L._correlate_plain(x, w, off), w, cot)
        got = LB.lista3d_wgrad_plain(x, cot, taps, off, alpha=-1.0)
        assert _rel(got, -want) <= 1e-5


@pytest.mark.parametrize("P,s", GEOMS)
@pytest.mark.parametrize("with_base,alpha", [(False, 1.0), (True, -1.0)])
def test_syn_adjoint_plain_is_the_synthesis_vjp(P, s, with_base, alpha):
    geom, wa, ws, z, _, _, g, base = _phase_setup(P, s)
    zz = z.clone().requires_grad_()
    vjp, = torch.autograd.grad(L.lista3d_syn_residual_plain(zz, ws, geom), zz, g)
    dz = alpha * vjp + (base if with_base else 0.0)
    dv, dtau = LB.lista3d_syn_adjoint_plain(g, LB.adjoint_bank(ws), z, geom,
                                            base=base if with_base else None,
                                            alpha=alpha)
    assert _rel(dv, torch.where(z != 0, dz, torch.zeros_like(dz))) <= 1e-5
    assert _rel(dtau, -(torch.sign(z) * dz).sum(dim=(2, 3, 4))) <= 1e-5


@pytest.mark.parametrize("P,s", GEOMS)
def test_syn_residual_with_adjoint_bank_is_the_analysis_vjp(P, s):
    geom, wa, _, _, r, dv, _, _ = _phase_setup(P, s)
    mask = (torch.rand(r.shape, generator=torch.Generator().manual_seed(0)) > 0.5).float()
    rr = r.clone().requires_grad_()
    vjp, = torch.autograd.grad(L._correlate_plain(rr, wa, geom.off_a), rr, dv)
    got = L.lista3d_syn_residual_plain(dv, LB.adjoint_bank(wa), geom, mask=mask)
    assert _rel(got, mask * vjp) <= 1e-5


@pytest.mark.parametrize("P,s", GEOMS)
def test_synthesis_wgrad_is_the_adjoint_of_the_swapped_product(P, s):
    """The reverse loop computes a synthesis bank's gradient as the
    adjoint_bank of the product with x and y swapped at the analysis
    offsets; the identity is exact up to summation order."""
    geom, wa, _, z, _, _, g, _ = _phase_setup(P, s)
    taps = tuple(wa.shape[1:4])
    want = LB.lista3d_wgrad_plain(z, g, taps, geom.off_s)
    got = LB.adjoint_bank(LB.lista3d_wgrad_plain(g, z, taps, geom.off_a))
    assert _rel(got, want) <= 1e-5


def test_adjoint_bank_swaps_the_two_preps():
    P, s = (7, 7, 5), 2
    W = torch.from_numpy(_inputs(P)["A"])
    pads = tuple(p // 2 for p in P)
    wa, ws = L.prep_A2m_3d(W, s, pads), L.prep_B2m_3d(W, s, pads)
    assert torch.equal(LB.adjoint_bank(wa), ws)
    assert torch.equal(LB.adjoint_bank(ws), wa)


# --- (2) the port's reverse loop against the JAX XLA scan's autodiff
# (1e-4 relative, the JAX package's own gate for its reverse kernels) ---

@pytest.mark.parametrize("P,s,use_mask", [((7, 7, 5), 2, False), ((7, 7, 5), 2, True),
                                          ((5, 5, 3), 2, True), ((5, 5, 3), 1, False)])
def test_fused_diff_matches_jax_xla_scan(P, s, use_mask, monkeypatch):
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    d = _inputs(P, seed=2)
    pads = tuple(p // 2 for p in P)
    mask = jnp.asarray(d["mask"]) if use_mask else None

    def loss_ref(A, B, t):
        z = jax_lista_3d(jnp.asarray(d["yp"]), A, B, t, jnp.asarray(d["c"]),
                         mask=mask, stride=s)
        x = jax_conv_transpose3d(z, B[0], stride=s, padding=pads, output_padding=s - 1)
        return jnp.mean((x - jnp.asarray(d["tgt"])) ** 2)

    v_ref, g_ref = jax.value_and_grad(loss_ref, argnums=(0, 1, 2))(
        *(jnp.asarray(d[k]) for k in "ABt"))
    v, *g = _port_grads(d, s, use_mask)
    np.testing.assert_allclose(v, float(v_ref), rtol=1e-5)
    for name, a, b in zip("ABt", g, g_ref):
        assert _rel(a, b) <= 1e-4, name


def test_fused_forward_histories_match_jax(monkeypatch):
    """return_hists keeps every z_k and r_k, in fp32: JAX's contract."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    P, s, K, M = (5, 5, 3), 2, 3, 6
    d = _inputs(P, K=K, M=M, seed=3)
    _, _, (zj, rj) = jax_lista3d_fused(
        *(jnp.asarray(d[k]) for k in ("yp", "A", "B", "t", "c")), stride=s,
        mask=jnp.asarray(d["mask"]), return_z=False, z_dtype=jnp.float32,
        interpret=True, return_hists=True)
    _, _, (zt, rt) = L.lista3d_fused(
        *(torch.from_numpy(d[k]) for k in ("yp", "A", "B", "t", "c")), stride=s,
        mask=torch.from_numpy(d["mask"]), return_hists=True)
    assert zt.dtype == rt.dtype == torch.float32
    N, Dc, Hc, Wc = 2, 4, 8, 8
    # JAX keeps (K, N, Dc, ch, Hc*Wc) with the code channels padded to 8
    zj = np.asarray(zj)[:, :, :, :M].reshape(K, N, Dc, M, Hc, Wc).transpose(0, 1, 3, 2, 4, 5)
    rj = np.asarray(rj).reshape(K - 1, N, Dc, 8, Hc, Wc).transpose(0, 1, 3, 2, 4, 5)
    np.testing.assert_allclose(zt.numpy(), zj, atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), rj, atol=1e-5)


# --- (3) the TPU reverse kernels themselves, K2 (whole-K resident) and K4
# (per-iteration pair), in interpret mode at their tests' smallest shape:
# the same 1e-4 relative gate ---

@pytest.fixture(scope="module")
def reverse_case():
    """The interpret-mode forward (fp32 histories) both reverse kernels
    start from, run once for the module."""
    P, s, K, M = (5, 5, 3), 2, 2, 6
    d = _inputs(P, K=K, M=M, seed=4)
    args = [jnp.asarray(d[k]) for k in ("yp", "A", "B", "t", "c")]
    mask = jnp.asarray(d["mask"])
    x, _, (zh, rh) = jax_lista3d_fused(*args, stride=s, mask=mask, return_z=False,
                                       z_dtype=jnp.float32, interpret=True,
                                       return_hists=True)
    dxp = 2.0 * (x - jnp.asarray(d["tgt"])) / x.size
    return d, s, args, mask, zh, rh, dxp


@pytest.mark.parametrize("kernel", ["K2", "K4"])
def test_reverse_matches_jax_reverse_kernel_interpret(kernel, reverse_case, monkeypatch):
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    d, s, args, mask, zh, rh, dxp = reverse_case
    run = jax_k2_bwd if kernel == "K2" else jax_k4_bwd
    g_ref = run(dxp, *args[:4], args[4], mask, zh, rh, stride=s, interpret=True)
    _, *g = _port_grads(d, s, True, dx=np.asarray(dxp))
    for name, a, b in zip("ABt", g, g_ref):
        assert _rel(a, b) <= 1e-4, name


# --- (4) model gradients: backend "pallas" (the port's reverse loop) against
# backend "xla" (torch autograd) and the JAX model (1e-4 relative) ---

SMALL = dict(K=3, M=8, P=(7, 7, 5), s=2, C=1, adaptive=True, depth=4)


def _small_params(seed=0):
    params = jax.tree_util.tree_map(
        np.asarray, JaxCDLNetVideo(**SMALL).init(jax.random.PRNGKey(seed), init=True))
    params["t"] = np.abs(np.random.default_rng(seed).standard_normal(
        params["t"].shape)).astype(np.float32) * 0.05
    return params


def test_model_gradients_match_xla_and_jax(monkeypatch):
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    params = _small_params()
    rng = np.random.default_rng(5)
    y = rng.uniform(size=(2, 1, 7, 18, 22)).astype(np.float32)  # odd sizes pad
    clean = rng.uniform(size=y.shape).astype(np.float32)
    sigma = np.array([15.0, 35.0], np.float32)

    def port(backend):
        m = load_jax_params(CDLNetVideo(**SMALL, backend=backend), params)
        loss = mse_loss(m(torch.from_numpy(y), torch.from_numpy(sigma))[0],
                        torch.from_numpy(clean))
        return [g.numpy() for g in torch.autograd.grad(loss, (m.A, m.B, m.t))]

    jm = JaxCDLNetVideo(**SMALL)
    g_jax = jax.grad(lambda p: jax_mse_loss(jm.apply(
        p, jnp.asarray(y), jnp.asarray(sigma), return_z=False, train=True)[0],
        jnp.asarray(clean)))(jax.tree_util.tree_map(jnp.asarray, params))
    g_pal, g_xla = port("pallas"), port("xla")
    for name, a, b, c in zip("ABt", g_pal, g_xla, (g_jax[k] for k in "ABt")):
        assert _rel(a, b) <= 1e-4, name
        assert _rel(a, c) <= 1e-4, name


def test_grad_forward_with_codes_raises():
    m = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=2, backend="pallas")
    with pytest.raises(NotImplementedError, match="return_z"):
        m(torch.zeros(1, 1, 4, 8, 8), 25.0, return_z=True)
    with torch.no_grad():
        assert m(torch.zeros(1, 1, 4, 8, 8), 25.0, return_z=True)[1] is not None


# --- (5) the optimizer against optax chain(clip_by_global_norm, adam):
# 1e-6 relative (the same fp32 formula, a few ulps apart where the sums
# of the global norm and XLA's fused arithmetic round differently) ---

@pytest.mark.parametrize("clip", [0.05, 1e3, None], ids=["clipped", "unclipped", "no-clip"])
def test_optimizer_matches_optax(clip):
    rng = np.random.default_rng(6)
    shapes = {"A": (3, 4, 1, 3, 3, 3), "B": (3, 4, 1, 3, 3, 3), "t": (3, 2, 4, 1, 1, 1)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jopt = jax_make_optimizer(1e-2, clip_grad=clip)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jp)
    opt = make_optimizer(1e-2, clip_grad=clip)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = opt.init(tp)
    for g in grads:
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        opt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, state)
    adam = jstate[-1].inner_state[0]
    assert state["count"] == int(adam.count) == 3
    for k in shapes:
        assert _rel(tp[k], jp[k]) <= 1e-6
        assert _rel(state["mu"][k], adam.mu[k]) <= 1e-6
        assert _rel(state["nu"][k], adam.nu[k]) <= 1e-6


def test_lr_helpers():
    state = make_optimizer(1e-3, clip_grad=1.0).init({"w": torch.zeros(2)})
    assert get_lr(state) == pytest.approx(1e-3)
    assert get_lr(set_lr(state, 5e-4)) == pytest.approx(5e-4)
    assert steplr_value(1e-3, 100, 50, 0.95) == pytest.approx(1e-3 * 0.95**2)


# --- (6) a 30-step trajectory on fixed batches and noise against a JAX loop
# of model.apply(xla) + mse_loss + opt.update + project ---

TRAJ = dict(K=3, M=6, P=(5, 5, 3), s=2, C=1, adaptive=True, depth=4)


def _clips(n, seed, shape=(2, 1, 4, 16, 16)):
    rng = np.random.default_rng(seed)
    g = [np.linspace(-np.pi, np.pi, k, dtype=np.float32) for k in shape[2:]]
    T, Y, X = np.meshgrid(*g, indexing="ij")
    out = []
    for _ in range(n):
        a, b, c = rng.uniform(0.5, 3, 3)
        clip = 0.5 + 0.25 * np.sin(a * X) * np.cos(b * Y) * np.cos(c * T)
        out.append(np.broadcast_to(clip, shape).astype(np.float32).copy())
    return out


def test_30_step_trajectory_tracks_jax(monkeypatch):
    """Each step: the same noisy batch (fixed arrays) to both loops. The
    trajectory is held at 1e-4 relative on the loss and 2e-4 relative on
    the parameters after 30 steps: fp32 rounding differences of ~1e-7 per
    step compound through Adam's normalized updates."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    params = jax.tree_util.tree_map(
        np.asarray, JaxCDLNetVideo(**TRAJ).init(jax.random.PRNGKey(1), init=True))
    params["t"] = np.full(params["t"].shape, 0.01, np.float32)
    rng = np.random.default_rng(7)
    batches = _clips(30, seed=8)
    sigmas = [rng.uniform(20, 30, (2, 1, 1, 1, 1)).astype(np.float32) for _ in batches]
    noisy = [b + rng.standard_normal(b.shape).astype(np.float32) * s / 255
             for b, s in zip(batches, sigmas)]

    jm = JaxCDLNetVideo(**TRAJ)
    jopt = jax_make_optimizer(2e-3, clip_grad=0.05)

    @jax.jit
    def jstep(p, st, y, sig, clean):
        loss, g = jax.value_and_grad(lambda q: jax_mse_loss(
            jm.apply(q, y, sig, return_z=False, train=True)[0], clean))(p)
        upd, st = jopt.update(g, st, p)
        return jm.project(jax.tree_util.tree_map(lambda a, u: a + u, p, upd)), st, loss

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jopt.init(jp)
    model = load_jax_params(CDLNetVideo(**TRAJ, backend="pallas"), params)
    opt = make_optimizer(2e-3, clip_grad=0.05)
    state = opt.init(dict(model.named_parameters()))
    jl, tl = [], []
    for y, sig, clean in zip(noisy, sigmas, batches):
        jp, jst, loss = jstep(jp, jst, jnp.asarray(y), jnp.asarray(sig), jnp.asarray(clean))
        jl.append(float(loss))
        tl.append(float(train_update(model, opt, state, torch.from_numpy(y),
                                     torch.from_numpy(sig), torch.from_numpy(clean))))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert np.mean(tl[-5:]) < np.mean(tl[:5])
    got = export_jax_params(model)
    for k in "ABt":
        assert _rel(got[k], jp[k]) <= 2e-4, k


# --- (7) checkpoints in both directions, Adam moments and lr included ---

def _trained(tmp_path, steps=2):
    model = CDLNetVideo(**TRAJ, backend="pallas").init(torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3, clip_grad=0.05)
    state = opt.init(dict(model.named_parameters()))
    step, _ = make_train_step(model, opt, noise_std=(20, 30))
    gen = torch.Generator().manual_seed(0)
    for b in _clips(steps, seed=9):
        step(state, torch.from_numpy(b), gen)
    return model, opt, state


def test_ckpt_port_to_jax(tmp_path):
    model, opt, state = _trained(tmp_path)
    set_lr(state, 3e-4)
    save_ckpt(str(tmp_path / "net.ckpt"), model, 7, state, get_lr(state))
    jm = JaxCDLNetVideo(**TRAJ)
    tmpl = jm.init(jax.random.PRNGKey(0), init=False)
    jopt = jax_make_optimizer(1e-3, clip_grad=0.05)
    jp, jst, epoch, lr = jax_ckpt.load_ckpt(str(tmp_path / "net.ckpt"), tmpl, jopt.init(tmpl))
    assert epoch == 7 and lr == pytest.approx(3e-4)
    assert float(jst[1].hyperparams["learning_rate"]) == pytest.approx(3e-4)
    adam = jst[1].inner_state[0]
    assert int(adam.count) == int(jst[1].count) == 2
    want = export_jax_params(model)
    for k in "ABt":
        np.testing.assert_array_equal(np.asarray(jp[k]), want[k])
        np.testing.assert_array_equal(np.asarray(adam.mu[k]), state["mu"][k].numpy())
        np.testing.assert_array_equal(np.asarray(adam.nu[k]), state["nu"][k].numpy())


def test_ckpt_jax_to_port(tmp_path):
    jm = JaxCDLNetVideo(**TRAJ)
    jp = jm.init(jax.random.PRNGKey(2), init=True)
    jopt = jax_make_optimizer(1e-3, clip_grad=0.05)
    jst = jopt.init(jp)
    g = jax.tree_util.tree_map(lambda p: 0.01 * jnp.ones_like(p), jp)
    _, jst = jopt.update(g, jst, jp)
    jax_ckpt.save_ckpt(str(tmp_path / "j.ckpt"), jp, 4, jst, 5e-4)
    model = CDLNetVideo(**TRAJ)
    state = make_optimizer(1e-3, clip_grad=0.05).init(dict(model.named_parameters()))
    _, state, epoch, lr = load_ckpt(str(tmp_path / "j.ckpt"), model, state)
    assert epoch == 4 and lr == pytest.approx(5e-4) and state["count"] == 1
    for k in "ABt":
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(state["mu"][k].numpy(),
                                      np.asarray(jst[1].inner_state[0].mu[k]))


def test_demo_ckpt_loads_with_adam_state():
    model = CDLNetVideo(K=8, M=32, P=(5, 5, 3), s=2, adaptive=True)
    state = make_optimizer(2e-3, clip_grad=1.0).init(dict(model.named_parameters()))
    _, state, epoch, lr = load_ckpt(os.path.join(DEMO, "net.ckpt.npz"), model, state)
    data = np.load(os.path.join(DEMO, "net.ckpt.npz"))
    assert epoch == 150 and lr == pytest.approx(7.036874740151688e-05)
    assert state["count"] == int(data["o::[1].count"])
    assert get_lr(state) == pytest.approx(float(data["o::[1].hyperparams['learning_rate']"]))
    np.testing.assert_array_equal(state["nu"]["B"].numpy(),
                                  data["o::[1].inner_state[0].nu['B']"])


def test_resumed_step_continues_identically(tmp_path):
    model, opt, state = _trained(tmp_path)
    save_ckpt(str(tmp_path / "ck"), model, 2, state, get_lr(state))
    model2 = CDLNetVideo(**TRAJ, backend="pallas")
    state2 = opt.init(dict(model2.named_parameters()))
    load_ckpt(str(tmp_path / "ck"), model2, state2)
    batch = torch.from_numpy(_clips(1, seed=10)[0])
    losses = []
    for m, st in ((model, state), (model2, state2)):
        step, _ = make_train_step(m, opt, noise_std=(20, 30))
        losses.append(step(st, batch, torch.Generator().manual_seed(5)))
    assert torch.equal(losses[0], losses[1])
    for k in "ABt":
        assert torch.equal(getattr(model, k), getattr(model2, k))
        assert torch.equal(state["nu"][k], state2["nu"][k])


# --- (8) fit(): JAX's log formats, and backtracking on a forced NaN ---

def _loaders(n=4, poison_epoch=None):
    clips = [c[:1] for c in _clips(n, seed=11)]

    class Train:
        epoch = 0

        def __iter__(self):
            Train.epoch += 1
            for i in range(0, n, 2):
                b = np.concatenate(clips[i:i + 2])
                yield b + np.nan if Train.epoch == poison_epoch else b

    return {"train": Train(), "val": [c for c in clips[:2]], "test": clips[:1]}


def test_fit_writes_jax_formats(tmp_path):
    model = CDLNetVideo(**TRAJ, backend="pallas").init(torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3, clip_grad=0.05)
    state = opt.init(dict(model.named_parameters()))
    state, history = fit(model, opt, state, _loaders(), save_dir=str(tmp_path), epochs=3,
                         noise_std=(20, 30), val_freq=2, save_freq=1, verbose=False,
                         sched={"step_size": 2, "gamma": 0.5})
    assert [(e, ph) for e, ph, _ in history] == [
        (1, "train"), (2, "train"), (2, "val"), (3, "train"), (3, "test")]
    for phase in ("train", "val", "test"):
        text = (tmp_path / f"{phase}.txt").read_text()
        assert re.fullmatch(r"(-?\d+\.\d{3}, )+", text), text
        want = [p for _, ph, p in history if ph == phase]
        assert text == "".join(f"{p:.3f}, " for p in want)
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["epoch"], r["phase"]) for r in rows] == [(e, ph) for e, ph, _ in history]
    assert all(set(r) == {"ts", "event", "epoch", "phase", "psnr", "lr", "steps", "sec"}
               for r in rows)
    assert get_lr(state) == pytest.approx(0.5e-3)  # StepLR at epoch 2
    for name in ("0.ckpt.npz", "net.ckpt.npz"):
        assert (tmp_path / name).exists()
    reloaded = CDLNetVideo(**TRAJ)
    _, _, epoch, _ = load_ckpt(str(tmp_path / "net.ckpt.npz"), reloaded)
    assert epoch == 3 and torch.equal(reloaded.A, model.A)
    assert (model.t >= 0).all()
    norms = model.A.detach().flatten(3).norm(dim=3)
    assert (norms <= 1 + 1e-5).all()


def test_fit_backtracks_on_nan(tmp_path):
    model = CDLNetVideo(**TRAJ, backend="pallas").init(torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3, clip_grad=1.0)
    state = opt.init(dict(model.named_parameters()))
    state, history = fit(model, opt, state, _loaders(poison_epoch=3),
                         save_dir=str(tmp_path), epochs=4, noise_std=25, val_freq=100,
                         save_freq=1, verbose=False, backtrack_thresh=1)
    assert (tmp_path / "backtrack.txt").read_text() == "3  "
    assert get_lr(state) == pytest.approx(1e-3 * 0.8)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    events = [json.loads(line)["event"]
              for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert "backtrack" in events


@pytest.mark.parametrize("kw", [dict(workload="mri", mcsure=True), dict(mcsure=True),
                                dict(stateful=True), dict(loss_type="combmse"),
                                dict(mesh={"data": -1})])
def test_unported_training_options_raise(kw):
    """stateful=True is ported (tests/test_torch_dncnn.py): on a model with
    no running statistics it raises a ValueError that says so. MC-SURE and
    the combined loss are ported (tests/test_torch_losses.py), and so are
    meshes (tests/test_torch_dist*.py; on one process a mesh is the
    trivial one-rank mesh): their steps run, with a finite loss."""
    model = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=2)
    if kw.get("stateful"):
        with pytest.raises(ValueError, match="running statistics"):
            make_train_step(model, make_optimizer(1e-3), **kw)
        return
    model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3)
    step, _ = make_train_step(model, opt, **kw)
    clean = torch.rand((1, 1, 4, 16, 16), generator=torch.Generator().manual_seed(1))
    loss = step(opt.init(dict(model.named_parameters())), clean,
                torch.Generator().manual_seed(2))
    assert torch.isfinite(loss)


def test_fit_device_scan_raises(tmp_path):
    """device_scan=True on a train loader that cannot be staged (lists of
    batches, not a VideoClipDataset loader) raises the JAX package's
    ValueError."""
    model = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=2)
    opt = make_optimizer(1e-3)
    with pytest.raises(ValueError, match="device_scan"):
        fit(model, opt, opt.init(dict(model.named_parameters())), _loaders(),
            save_dir=str(tmp_path), device_scan=True)


# --- noise, losses, init_model ---

def test_awgn3d_range_and_scalar():
    x = torch.zeros(3, 1, 2, 8, 8)
    noisy, sigma = awgn3d(x, (20, 30), torch.Generator().manual_seed(0))
    assert sigma.shape == (3, 1, 1, 1, 1) and ((sigma >= 20) & (sigma <= 30)).all()
    again, _ = awgn3d(x, (20, 30), torch.Generator().manual_seed(0))
    assert torch.equal(noisy, again)
    ratio = noisy.flatten(1).std(dim=1) / (sigma.flatten() / 255)
    assert ((ratio > 0.7) & (ratio < 1.3)).all()
    _, s = awgn3d(x, 25, torch.Generator().manual_seed(0))
    assert s.ndim == 0 and float(s) == 25.0
    assert torch.equal(gen_bayer_mask3d(x), torch.ones_like(x))


def test_psnr_from_mse():
    assert psnr_from_mse(1e-2) == pytest.approx(20.0)


def test_init_model_from_args(tmp_path):
    args = {"type": "CDLNetVideo",
            "model": {"K": 2, "M": 4, "P": [3, 3, 3], "s": 2, "adaptive": True},
            "paths": {"save": str(tmp_path), "ckpt": None},
            "train": {"opt": {"lr": 1e-3}, "fit": {"clip_grad": 0.05}}}
    model, opt, state, epoch0, lr = init_model(args, device="cpu")
    assert epoch0 == 0 and lr == pytest.approx(1e-3) and state["index"] == 1
    save_ckpt(str(tmp_path / "net.ckpt"), model, 11, state, 3e-4)
    args["paths"]["ckpt"] = str(tmp_path / "net.ckpt")
    model2, _, state2, epoch2, _ = init_model(args, device="cpu")
    assert epoch2 == 11 and get_lr(state2) == pytest.approx(3e-4)
    assert torch.equal(model2.A, model.A)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"type": "CDLNetVideo", "model": {"K": 2, "M": 4, "P": [3, 3, 3], "s": 2}}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_model(args)
