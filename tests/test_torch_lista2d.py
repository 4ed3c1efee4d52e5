"""cdlnet_tpu_torch/kernels/lista2d.py on the CPU: the kernels' plain
versions against a direct strided-conv LISTA step, and the fused forward
against the JAX package's whole-image Pallas kernel (K5) and banded pair
(K7), both in interpret mode, and its XLA scan."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cdlnet_tpu.kernels.lista2d import lista2d_fused as jax_lista2d_fused
from cdlnet_tpu.kernels.lista2d_tiled import lista2d_tiled as jax_lista2d_tiled
from cdlnet_tpu.ops.conv import conv_transpose2d as jax_conv_transpose2d
from cdlnet_tpu.ops.lista import lista_2d as jax_lista_2d
from cdlnet_tpu_torch.core.ops import ST
from cdlnet_tpu_torch.kernels import _build
from cdlnet_tpu_torch.kernels import lista2d as L2
from cdlnet_tpu_torch.kernels import lista3d as L
from cdlnet_tpu_torch.ops import polyphase as pp
from cdlnet_tpu_torch.ops.conv import conv2d, conv_transpose2d


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


K, M = 3, 13


def _inputs(P, s, C, H, W, seed=0, N=2):
    """Seeded numpy inputs shared by both packages; c differs per image."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    yp = 0.3 * f(N, C, H, W)
    A = 0.1 * f(K, M, C, P, P)
    B = 0.1 * f(K, M, C, P, P)
    t = 0.02 * np.abs(f(K, 2, M, 1, 1))
    c = np.array([0.1, 0.2][:N], np.float32).reshape(N, 1, 1, 1)
    mask = (rng.uniform(size=yp.shape) > 0.5).astype(np.float32)
    return yp, A, B, t, c, mask


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


# (P, s, C): the flagship's stride-2 grayscale form, JDD's stride-1 colour
# form, and stride 2 with colour (the phase map is channel % s^2)
STEPS = [(7, 2, 1), (7, 1, 3), (5, 2, 3)]


@pytest.mark.parametrize("P,s,C", STEPS)
def test_ana_threshold_plain_is_one_strided_analysis(P, s, C):
    yp, A, B, t, c, mask = _torch(*_inputs(P, s, C, 16, 12))
    pad = (P - 1) // 2
    geom = L.Geom(s, (P, P), (pad, pad))
    tau = t[1, 0] + c * t[1, 1]  # (N, M, 1, 1)
    z0 = ST(conv2d(yp, A[0], stride=s, padding=pad), tau)
    r = mask * conv_transpose2d(z0, B[1], stride=s, padding=pad,
                                output_padding=s - 1) - yp
    want = ST(z0 - conv2d(r, A[1], stride=s, padding=pad), tau)
    wa = L2.prep_A2m_2d(A, s, (pad, pad))
    got = L2.lista2d_ana_threshold_plain(pp.space_to_depth(r, s, 2), z0, wa[1],
                                         tau.reshape(2, M), geom)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    first = L2.lista2d_ana_threshold_plain(-pp.space_to_depth(yp, s, 2), None, wa[0],
                                           tau.reshape(2, M), geom)
    np.testing.assert_allclose(first.numpy(), z0.numpy(), atol=1e-5)


@pytest.mark.parametrize("P,s,C", STEPS)
@pytest.mark.parametrize("residual", [False, True])
def test_syn_residual_plain_is_one_strided_synthesis(P, s, C, residual):
    yp, A, B, t, c, mask = _torch(*_inputs(P, s, C, 16, 12))
    pad = (P - 1) // 2
    geom = L.Geom(s, (P, P), (pad, pad))
    z = conv2d(yp, A[0], stride=s, padding=pad)
    Bz = conv_transpose2d(z, B[2], stride=s, padding=pad, output_padding=s - 1)
    want = mask * Bz - yp if residual else Bz
    kw = dict(mask=pp.space_to_depth(mask, s, 2), y=pp.space_to_depth(yp, s, 2)) \
        if residual else {}
    got = L2.lista2d_syn_residual_plain(z, L2.prep_B2m_2d(B, s, (pad, pad))[2], geom, **kw)
    np.testing.assert_allclose(pp.depth_to_space(got, s, 2, C).numpy(), want.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("use_mask", [False, True])
def test_fused_matches_jax_pallas_interpret(use_mask):
    """K5, the whole-image kernel, with per-image c (unmasked, the JAX
    wrapper folds the two images into one tall one)."""
    yp, A, B, t, c, mask = _inputs(7, 2, 1, 32, 16)
    m = mask if use_mask else None
    xj, zj = jax_lista2d_fused(
        *map(jnp.asarray, (yp, A, B, t, c)), stride=2,
        mask=None if m is None else jnp.asarray(m), return_z=True, interpret=True)
    xt, zt = L2.lista2d_fused(*_torch(yp, A, B, t, c), stride=2,
                              mask=None if m is None else torch.from_numpy(m),
                              return_z=True)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4)


def test_fused_matches_jax_tiled_interpret():
    """K7, the banded pair: a 64x32 image is two bands of 16 code rows."""
    yp, A, B, t, c, mask = _inputs(7, 2, 1, 64, 32, seed=2)
    xj, zj = jax_lista2d_tiled(*map(jnp.asarray, (yp, A, B, t, c)), stride=2,
                               mask=jnp.asarray(mask), return_z=True,
                               z_dtype=jnp.float32, interpret=True, band=16)
    xt, zt = L2.lista2d_fused(*_torch(yp, A, B, t, c), stride=2,
                              mask=torch.from_numpy(mask), return_z=True)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4)


@pytest.mark.parametrize("P,s,C,use_mask", [(7, 2, 1, False), (7, 1, 3, True),
                                            (5, 2, 3, True)])
def test_fused_matches_jax_scan(P, s, C, use_mask):
    yp, A, B, t, c, mask = _inputs(P, s, C, 20, 14, seed=1)
    m = mask if use_mask else None
    zj = jax_lista_2d(*map(jnp.asarray, (yp, A, B, t, c)),
                      mask=None if m is None else jnp.asarray(m), stride=s)
    xj = jax_conv_transpose2d(zj, jnp.asarray(B[0]), stride=s, padding=(P - 1) // 2,
                              output_padding=s - 1)
    xt, zt = L2.lista2d_fused(*_torch(yp, A, B, t, c), stride=s,
                              mask=None if m is None else torch.from_numpy(m),
                              return_z=True)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4)


def test_fused_return_z_false_scalar_c_and_no_launches():
    yp, A, B, t, _, _ = _torch(*_inputs(5, 2, 1, 12, 8))
    L.launches.clear()
    x, z = L2.lista2d_fused(yp, A, B, t, 0.1, stride=2)
    x2, _ = L2.lista2d_fused(yp, A, B, t, torch.full((2, 1, 1, 1), 0.1), stride=2)
    assert z is None and x.shape == yp.shape
    torch.testing.assert_close(x, x2, rtol=0, atol=0)
    assert sum(L.launches.values()) == 0


def test_wrappers_write_into_out():
    yp, A, B, t, c, _ = _torch(*_inputs(5, 2, 1, 12, 8))
    y2, _, wa, ws, tau, geom = L2.phase_operands(yp, A, B, t, c, 2)
    z0 = L2.lista2d_ana_threshold(-y2, None, wa[0], tau[0], geom)
    buf = torch.zeros_like(z0)
    assert L2.lista2d_ana_threshold(-y2, None, wa[0], tau[0], geom, out=buf) is buf
    assert torch.equal(buf, z0)
    r = L2.lista2d_syn_residual(z0, ws[1], geom, y=y2)
    rb = torch.zeros_like(y2)
    assert L2.lista2d_syn_residual(z0, ws[1], geom, y=y2, out=rb) is rb
    assert torch.equal(rb, r)


@pytest.mark.parametrize("names", [("z_prev", "g"), ("z_after", "g2"),
                                   ("z_prev", "z_after", "g", "g2"), ("z_after", "g", "g2")])
def test_unported_modes_raise(names, monkeypatch):
    """The CSR prox modes run, and with histories (training; the test's
    name is from before they were ported) they return the z, r and u
    histories (fp32: CDLNET_HIST_DTYPE=f32) and the same output and codes
    as without."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")
    yp, A, B, t, c, _ = _torch(*_inputs(5, 2, 1, 12, 8))
    kw = {name: torch.zeros(2, M, 6, 4) if name.startswith("z") else 0.5 * t
          for name in names}
    x, z = L2.lista2d_fused(yp, A, B, t, c, stride=2, return_z=True, **kw)
    assert x.shape == yp.shape and z.shape == (2, M, 6, 4)
    xh, zh, hists = L2.lista2d_fused(yp, A, B, t, c, stride=2, return_z=True,
                                     return_hist=True, **kw)
    assert torch.equal(xh, x) and torch.equal(zh, z)
    K = A.shape[0]
    assert [tuple(h.shape) for h in hists] == [(K, 2, M, 6, 4), (K - 1, 2, 4, 6, 4),
                                               (K, 2, M, 6, 4)]
    assert torch.equal(hists[0][-1], z)


@pytest.mark.parametrize("which", ["ana", "syn"])
def test_non_cpu_tensor_without_library_raises(which, monkeypatch, tmp_path):
    """A tensor off the CPU never takes the plain version: with no kernel
    library to be had, the wrapper raises instead of falling back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    _build.library.cache_clear()
    try:
        meta = lambda *sh: torch.empty(*sh, device="meta")
        geom = L.Geom(2, (7, 7), (3, 3))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            if which == "ana":
                L2.lista2d_ana_threshold(meta(1, 4, 8, 8), None, meta(4, 4, 4, 5),
                                         meta(1, 5), geom)
            else:
                L2.lista2d_syn_residual(meta(1, 5, 8, 8), meta(5, 4, 4, 4), geom)
    finally:
        _build.library.cache_clear()
