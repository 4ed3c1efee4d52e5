"""The 2D (image) training path of cdlnet_tpu_torch on the CPU, at tiny
shapes, against its own definitions and the JAX package: the reverse
kernels' plain versions against the VJPs of one strided step, the forward's
histories against K5's, the reverse loop against JAX's whole-image (K6)
and banded (K8) reverse kernels in interpret mode and its XLA scan, and
the CDLNet, JDD and GDLNet parameter gradients. The training loop itself
(trajectory, fit, loaders, CLI) is tests/test_torch_cli_train.py.

Inputs and noise come from numpy seeds and go to both packages. All
comparisons are fp32; each tolerance is stated where it is used."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu.kernels.autodiff import lista2d_fused_diff as jax_lista2d_fused_diff
from cdlnet_tpu.kernels.lista2d import lista2d_fused as jax_lista2d_fused
from cdlnet_tpu.kernels.lista2d_tiled import lista2d_tiled as jax_lista2d_tiled
from cdlnet_tpu.kernels.lista2d_tiled_bwd import lista2d_tiled_fused_bwd as jax_k8_bwd
from cdlnet_tpu.models import CDLNet as JaxCDLNet
from cdlnet_tpu.models import GDLNet as JaxGDLNet
from cdlnet_tpu.ops.conv import conv_transpose2d as jax_conv_transpose2d
from cdlnet_tpu.ops.lista import lista_2d as jax_lista_2d
from cdlnet_tpu.train.losses import mse_loss as jax_mse_loss
from cdlnet_tpu_torch.compat.jax_params import load_jax_params
from cdlnet_tpu_torch.data.noise import gen_bayer_mask
from cdlnet_tpu_torch.kernels import _build
from cdlnet_tpu_torch.kernels import lista2d as L2
from cdlnet_tpu_torch.kernels import lista2d_bwd as LB2
from cdlnet_tpu_torch.kernels import lista3d as L
from cdlnet_tpu_torch.kernels.autodiff import lista2d_fused_diff
from cdlnet_tpu_torch.kernels.lista3d_bwd import adjoint_bank
from cdlnet_tpu_torch.models import CDLNet, GDLNet
from cdlnet_tpu_torch.ops import polyphase as pp
from cdlnet_tpu_torch.ops.conv import conv2d, conv_transpose2d
from cdlnet_tpu_torch.train.losses import mse_loss

# (P, s, C): the flagship's stride-2 grayscale form, JDD's stride-1 colour
# form, and stride 2 with colour (the phase map is channel % s^2)
STEPS = [(7, 2, 1), (7, 1, 3), (5, 2, 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' on these tiny shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(P, C=1, K=3, M=13, shape=(2, 16, 12), seed=0):
    """Seeded numpy inputs shared by both packages; c differs per image."""
    N, H, W = shape
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return dict(
        yp=0.3 * f(N, C, H, W), A=0.1 * f(K, M, C, P, P), B=0.1 * f(K, M, C, P, P),
        t=0.02 * np.abs(f(K, 2, M, 1, 1)),
        c=np.linspace(0.1, 0.3, N, dtype=np.float32).reshape(N, 1, 1, 1),
        mask=(rng.uniform(size=(N, C, H, W)) > 0.5).astype(np.float32),
        tgt=rng.uniform(size=(N, C, H, W)).astype(np.float32))


def _port_grads(d, s, use_mask, dx=None):
    """The port's gradients of mean((x - tgt)^2) (or of x against the
    cotangent dx) through lista2d_fused_diff: (loss, dA, dB, dt)."""
    A, B, t = (torch.from_numpy(d[k]).requires_grad_() for k in "ABt")
    x = lista2d_fused_diff(torch.from_numpy(d["yp"]), A, B, t, torch.from_numpy(d["c"]),
                           stride=s, mask=torch.from_numpy(d["mask"]) if use_mask else None)
    if dx is None:
        loss = torch.mean((x - torch.from_numpy(d["tgt"])) ** 2)
        return (float(loss.detach()),
                *(g.numpy() for g in torch.autograd.grad(loss, (A, B, t))))
    return (None, *(g.numpy() for g in torch.autograd.grad(x, (A, B, t),
                                                           torch.tensor(np.asarray(dx)))))


# --- (1) each reverse plain version against the VJP of one strided step
# (the Conv2d / ConvTranspose2d of the model, not the phase form): 1e-5
# relative, fp32 sums of <= 1k terms taken in another order ---

def _strided_setup(P, s, C, seed=0):
    d = _inputs(P, C=C, seed=seed)
    pad = (P - 1) // 2
    geom = L.Geom(s, (P, P), (pad, pad))
    A, B = torch.from_numpy(d["A"][1]), torch.from_numpy(d["B"][1])
    rng = np.random.default_rng(seed + 1)
    N, _, H, W = d["yp"].shape
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    z = f(N, A.shape[0], H // s, W // s)
    z = torch.where(z.abs() < 0.5, torch.zeros_like(z), z)  # sparse codes
    return geom, pad, A, B, z, f(N, C, H, W), f(N, C, H, W), f(*z.shape)


@pytest.mark.parametrize("P,s,C", STEPS)
@pytest.mark.parametrize("with_base,alpha", [(False, 1.0), (True, -1.0)])
def test_syn_adjoint_plain_is_the_synthesis_vjp(P, s, C, with_base, alpha):
    geom, pad, _, B, z, g_full, _, base = _strided_setup(P, s, C)
    zz = z.clone().requires_grad_()
    vjp, = torch.autograd.grad(
        conv_transpose2d(zz, B, stride=s, padding=pad, output_padding=s - 1), zz, g_full)
    dz = alpha * vjp + (base if with_base else 0.0)
    ws_adj = adjoint_bank(L2.prep_B2m_2d(B[None], s, (pad, pad))[0], 2)
    dv, dtau = LB2.lista2d_syn_adjoint_plain(pp.space_to_depth(g_full, s, 2), ws_adj, z,
                                             geom, base=base if with_base else None,
                                             alpha=alpha)
    assert _rel(dv, torch.where(z != 0, dz, torch.zeros_like(dz))) <= 1e-5
    assert _rel(dtau, -(torch.sign(z) * dz).sum(dim=(2, 3))) <= 1e-5


@pytest.mark.parametrize("P,s,C", STEPS)
def test_syn_residual_with_adjoint_bank_is_the_analysis_vjp(P, s, C):
    geom, pad, A, _, z, r_full, _, _ = _strided_setup(P, s, C)
    mask = (torch.rand(r_full.shape, generator=torch.Generator().manual_seed(0)) > 0.5).float()
    rr = r_full.clone().requires_grad_()
    vjp, = torch.autograd.grad(conv2d(rr, A, stride=s, padding=pad), rr, z)
    wa_adj = adjoint_bank(L2.prep_A2m_2d(A[None], s, (pad, pad))[0], 2)
    got = L2.lista2d_syn_residual_plain(z, wa_adj, geom, mask=pp.space_to_depth(mask, s, 2))
    assert _rel(pp.depth_to_space(got, s, 2, C), mask * vjp) <= 1e-5


@pytest.mark.parametrize("P,s,C", STEPS)
def test_wgrad_plain_gives_the_strided_weight_vjps(P, s, C):
    """dA of conv2d(r, A) and dB of conv_transpose2d(z, B), each through
    the VJP of its bank prep: the two products the reverse loop runs (the
    synthesis one as the adjoint bank of the swapped product)."""
    geom, pad, A, B, z, r_full, g_full, _ = _strided_setup(P, s, C)
    taps = tuple(L2.prep_A2m_2d(A[None], s, (pad, pad)).shape[2:4])
    r2, g2 = pp.space_to_depth(r_full, s, 2), pp.space_to_depth(g_full, s, 2)
    AA, BB = A.clone().requires_grad_(), B.clone().requires_grad_()
    want_a, = torch.autograd.grad(conv2d(r_full, AA, stride=s, padding=pad), AA, z)
    want_b, = torch.autograd.grad(conv_transpose2d(z, BB, stride=s, padding=pad,
                                                   output_padding=s - 1), BB, g_full)
    wa = L2.prep_A2m_2d(AA[None], s, (pad, pad))[0]
    got_a, = torch.autograd.grad(wa, AA, LB2.lista2d_wgrad_plain(r2, z, taps, geom.off_a))
    ws = L2.prep_B2m_2d(BB[None], s, (pad, pad))[0]
    dws = adjoint_bank(LB2.lista2d_wgrad_plain(g2, z, taps, geom.off_a), 2)
    got_b, = torch.autograd.grad(ws, BB, dws)
    assert _rel(got_a, want_a) <= 1e-5
    assert _rel(got_b, want_b) <= 1e-5
    assert _rel(dws, LB2.lista2d_wgrad_plain(z, g2, taps, geom.off_s)) <= 1e-5


@pytest.mark.parametrize("P,s,C", STEPS)
def test_adjoint_bank_swaps_the_two_2d_preps(P, s, C):
    W = torch.from_numpy(_inputs(P, C=C)["A"])
    pads = ((P - 1) // 2,) * 2
    wa, ws = L2.prep_A2m_2d(W, s, pads), L2.prep_B2m_2d(W, s, pads)
    assert torch.equal(adjoint_bank(wa, 2), ws)
    assert torch.equal(adjoint_bank(ws, 2), wa)


# --- (2) the forward's fp32 histories against K5's return_hist=True
# (interpret mode, fp32 histories): 1e-5 absolute ---

@pytest.mark.parametrize("use_mask", [False, True])
def test_fused_histories_match_jax_k5(use_mask, monkeypatch):
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")
    P, s, K, M = 5, 2, 3, 6
    d = _inputs(P, K=K, M=M, shape=(2, 16, 16), seed=3)
    mask = d["mask"] if use_mask else None
    _, _, hist = jax_lista2d_fused(
        *(jnp.asarray(d[k]) for k in ("yp", "A", "B", "t", "c")), stride=s,
        mask=None if mask is None else jnp.asarray(mask), interpret=True,
        return_hist=True)
    xt, zt, (zh, rh) = L2.lista2d_fused(
        *(torch.from_numpy(d[k]) for k in ("yp", "A", "B", "t", "c")), stride=s,
        mask=None if mask is None else torch.from_numpy(mask), return_z=True,
        return_hist=True)
    assert zh.dtype == rh.dtype == torch.float32
    assert zh.shape == (K, 2, M, 8, 8) and rh.shape == (K - 1, 2, 4, 8, 8)
    assert torch.equal(zh[K - 1], zt)
    # JAX: (N, K, Mp8 + Rp8, Hc*Wc), z_k in rows [0:M), r_k in [Mp8:Mp8+Cp)
    hist = np.asarray(hist).reshape(2, K, -1, 8, 8).transpose(1, 0, 2, 3, 4)
    np.testing.assert_allclose(zh.numpy(), hist[:, :, :M], atol=1e-5)
    np.testing.assert_allclose(rh.numpy(), hist[1:, :, 8:12], atol=1e-5)


# --- (3) the reverse loop against the JAX package: the XLA scan's autodiff,
# the whole-image reverse kernel K6 (through lista2d_fused_diff) and the
# banded K8, both in interpret mode; 1e-4 relative, the JAX package's own
# gate for its reverse kernels ---

@pytest.mark.parametrize("P,s,C,use_mask", [(7, 2, 1, False), (7, 2, 1, True),
                                            (7, 1, 3, True), (5, 2, 3, False)])
def test_fused_diff_matches_jax_xla_scan(P, s, C, use_mask, monkeypatch):
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    d = _inputs(P, C=C, shape=(2, 18, 14), seed=2)
    mask = jnp.asarray(d["mask"]) if use_mask else None

    def loss_ref(A, B, t):
        z = jax_lista_2d(jnp.asarray(d["yp"]), A, B, t, jnp.asarray(d["c"]),
                         mask=mask, stride=s)
        x = jax_conv_transpose2d(z, B[0], stride=s, padding=(P - 1) // 2,
                                 output_padding=s - 1)
        return jnp.mean((x - jnp.asarray(d["tgt"])) ** 2)

    v_ref, g_ref = jax.value_and_grad(loss_ref, argnums=(0, 1, 2))(
        *(jnp.asarray(d[k]) for k in "ABt"))
    v, *g = _port_grads(d, s, use_mask)
    np.testing.assert_allclose(v, float(v_ref), rtol=1e-5)
    for name, a, b in zip("ABt", g, g_ref):
        assert _rel(a, b) <= 1e-4, name


@pytest.mark.parametrize("P,C,M,K,use_mask,N", [(7, 1, 8, 3, False, 3), (5, 2, 6, 3, True, 2)])
def test_reverse_matches_jax_k6_interpret(P, C, M, K, use_mask, N, monkeypatch):
    """K6 at its own test's 16x16 shapes: folded images with per-image c
    (unmasked), and the masked JDD path."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")
    s = 2
    d = _inputs(P, C=C, K=K, M=M, shape=(N, 16, 16), seed=4)
    mask = jnp.asarray(d["mask"]) if use_mask else None

    def loss_k6(A, B, t):
        x = jax_lista2d_fused_diff(jnp.asarray(d["yp"]), A, B, t, jnp.asarray(d["c"]),
                                   stride=s, mask=mask, interpret=True)
        return jnp.mean((x - jnp.asarray(d["tgt"])) ** 2)

    v_ref, g_ref = jax.value_and_grad(loss_k6, argnums=(0, 1, 2))(
        *(jnp.asarray(d[k]) for k in "ABt"))
    v, *g = _port_grads(d, s, use_mask)
    np.testing.assert_allclose(v, float(v_ref), rtol=1e-5)
    for name, a, b in zip("ABt", g, g_ref):
        assert _rel(a, b) <= 1e-4, name


def test_reverse_matches_jax_k8_interpret(monkeypatch):
    """K8 at N=2 x 32x256: a 16x128 code grid in two bands of 8, masked,
    per-image c."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    P, s, K, M = 5, 2, 2, 8
    d = _inputs(P, K=K, M=M, shape=(2, 32, 256), seed=5)
    args = [jnp.asarray(d[k]) for k in ("yp", "A", "B", "t", "c")]
    mask = jnp.asarray(d["mask"])
    x, _, (zh, rh) = jax_lista2d_tiled(*args, stride=s, mask=mask, return_z=False,
                                       z_dtype=jnp.float32, interpret=True,
                                       return_hists=True, band=8)
    dxp = 2.0 * (x - jnp.asarray(d["tgt"])) / x.size
    g_ref = jax_k8_bwd(dxp, *args, mask, zh, rh, stride=s, interpret=True)
    _, *g = _port_grads(d, s, True, dx=dxp)
    for name, a, b in zip("ABt", g, g_ref):
        assert _rel(a, b) <= 1e-4, name


# --- (4) model gradients: backend "pallas" (the port's reverse loop) against
# backend "xla" (torch autograd) and jax.grad of the JAX model (1e-4) ---

FAMILIES = {
    "cdlnet": (JaxCDLNet, CDLNet, dict(K=3, M=8, P=7, s=2, C=1, adaptive=True), False),
    "jdd": (JaxCDLNet, CDLNet, dict(K=3, M=8, P=7, s=1, C=3, adaptive=True), True),
    "gdlnet": (JaxGDLNet, GDLNet, dict(K=3, M=8, P=7, s=2, C=1, order=1, adaptive=True,
                                       shared=""), False),
}


def _family_params(jax_cls, cfg, seed=0):
    params = jax.tree_util.tree_map(
        np.asarray, jax_cls(**cfg).init(jax.random.PRNGKey(seed), init=True))
    params["t"] = np.abs(np.random.default_rng(seed).standard_normal(
        params["t"].shape)).astype(np.float32) * 0.05
    return params


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_gradients_match_xla_and_jax(family, monkeypatch):
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    jax_cls, cls, cfg, masked = FAMILIES[family]
    params = _family_params(jax_cls, cfg)
    rng = np.random.default_rng(5)
    clean = rng.uniform(size=(2, cfg["C"], 19, 22)).astype(np.float32)  # odd sizes pad
    noisy = clean + 0.1 * rng.standard_normal(clean.shape).astype(np.float32)
    mask = gen_bayer_mask(torch.from_numpy(clean)).numpy() if masked else None
    y = noisy if mask is None else mask * noisy
    sigma = np.array([15.0, 35.0], np.float32)

    def port(backend):
        m = load_jax_params(cls(**cfg, backend=backend), params)
        out = m(torch.from_numpy(y), torch.from_numpy(sigma),
                mask=None if mask is None else torch.from_numpy(mask))[0]
        loss = mse_loss(out, torch.from_numpy(clean))
        named = dict(m.named_parameters())
        names = [k for k in sorted(named) if k != "g"]
        return dict(zip(names, (g.numpy() for g in
                                torch.autograd.grad(loss, [named[k] for k in names]))))

    jm = jax_cls(**cfg)
    g_jax = jax.grad(lambda p: jax_mse_loss(jm.apply(
        p, jnp.asarray(y), jnp.asarray(sigma),
        mask=None if mask is None else jnp.asarray(mask), return_z=False,
        train=True)[0], jnp.asarray(clean)))(jax.tree_util.tree_map(jnp.asarray, params))
    g_pal, g_xla = port("pallas"), port("xla")
    assert sorted(g_pal) == sorted(k for k in g_jax if k != "g")
    for name in g_pal:
        assert _rel(g_pal[name], g_xla[name]) <= 1e-4, name
        assert _rel(g_pal[name], g_jax[name]) <= 1e-4, name


@pytest.mark.parametrize("cls", [CDLNet, GDLNet])
def test_grad_forward_with_codes_raises(cls):
    m = cls(K=2, M=4, P=5, s=2, backend="pallas").init(torch.Generator().manual_seed(0),
                                                       init=False)
    with pytest.raises(NotImplementedError, match="return_z"):
        m(torch.zeros(1, 1, 8, 8), 25.0, return_z=True)
    with torch.no_grad():
        assert m(torch.zeros(1, 1, 8, 8), 25.0, return_z=True)[1] is not None


# --- (5) a tensor off the CPU never takes a plain version ---

@pytest.mark.parametrize("which", ["syn_adjoint", "wgrad"])
def test_non_cpu_tensor_without_library_raises(which, monkeypatch, tmp_path):
    """With no kernel library to be had, the new wrappers raise instead of
    falling back to their plain versions."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    _build.library.cache_clear()
    try:
        meta = lambda *sh: torch.empty(*sh, device="meta")
        geom = L.Geom(2, (7, 7), (3, 3))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            if which == "syn_adjoint":
                LB2.lista2d_syn_adjoint(meta(1, 4, 8, 8), meta(4, 4, 4, 5),
                                        meta(1, 5, 8, 8), geom)
            else:
                LB2.lista2d_wgrad(meta(1, 4, 8, 8), meta(1, 5, 8, 8), (4, 4), geom.off_a)
    finally:
        _build.library.cache_clear()
