"""The port's 3D LISTA path against the JAX package's big-frame TPU kernels
on the CPU: the banded pair K9 (`lista3d_tiled`) and the depth-ring kernel
K11 (`lista3d_ring`) for the forward, their reverse kernels K10
(`lista3d_tiled_fused_bwd`) and K12 (`lista3d_ring_fused_bwd`) for the
gradients, all in interpret mode at an fp32 carry and fp32 histories, and
`apply_with_codes`.

The port has no banded or ring kernel: one kernel pair and one reverse
set, with the codes in device memory, serve every frame size. So these
tests feed the JAX kernels' own test shapes (halo crossings between row
bands, a ragged code height, stride 1, colour with a mask, P=(9,9,5),
K=1) to the port's lista3d_fused and its reverse loop, whose CPU path is
the kernels' plain versions. Inputs are seeded numpy arrays given to both
packages."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cdlnet_tpu.kernels.lista3d_ring import lista3d_ring
from cdlnet_tpu.kernels.lista3d_ring_bwd import lista3d_ring_fused_bwd
from cdlnet_tpu.kernels.lista3d_tiled import lista3d_tiled
from cdlnet_tpu.kernels.lista3d_tiled_bwd import lista3d_tiled_fused_bwd
from cdlnet_tpu.models import CDLNetVideo as JaxCDLNetVideo
from cdlnet_tpu_torch.compat.jax_params import load_jax_params
from cdlnet_tpu_torch.kernels import lista3d as L
from cdlnet_tpu_torch.kernels.autodiff import lista3d_fused_diff
from cdlnet_tpu_torch.models import CDLNetVideo


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(s, P, C, M, K, shape, mask_shape=None, seed=0):
    """Seeded numpy inputs of one kernel test: yp, A, B, t (0.1-scaled
    banks, small positive thresholds), per-sample c, a 0/1 mask of
    mask_shape (or None) and an output cotangent gx."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    N = shape[0]
    d = dict(yp=0.3 * f(*shape), A=0.1 * f(K, M, C, *P), B=0.1 * f(K, M, C, *P),
             t=0.02 * np.abs(f(K, 2, M, 1, 1, 1)),
             c=np.linspace(0.1, 0.2, N, dtype=np.float32).reshape(N, 1, 1, 1, 1),
             gx=f(*shape))
    d["mask"] = (None if mask_shape is None
                 else (rng.uniform(size=mask_shape) > 0.5).astype(np.float32))
    return d


def _jax(d, *keys):
    return [None if d[k] is None else jnp.asarray(d[k]) for k in keys]


def _torch(d, *keys):
    return [None if d[k] is None else torch.from_numpy(d[k]) for k in keys]


def _port_forward(d, s):
    yp, A, B, t, c, mask = _torch(d, "yp", "A", "B", "t", "c", "mask")
    return L.lista3d_fused(yp, A, B, t, c, stride=s, mask=mask)


def _port_grads(d, s):
    """The port's dA, dB, dt of <x, gx> through lista3d_fused_diff (its
    reverse loop over fp32 histories)."""
    yp, c, mask, gx = _torch(d, "yp", "c", "mask", "gx")
    A, B, t = (p.requires_grad_() for p in _torch(d, "A", "B", "t"))
    x = lista3d_fused_diff(yp, A, B, t, c, stride=s, mask=mask)
    return torch.autograd.grad(x, (A, B, t), gx)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


# (s, P, C, M, K, D, H, W, band, masked) from the JAX kernels' own tests
TILED = {  # K9 and K10 (tests/test_kernels.py, the tiled 3D cases)
    "halo_crossings": (2, (5, 5, 3), 1, 8, 3, 8, 64, 16, 8, False),  # nb = 4
    "color_mask": (2, (5, 5, 3), 3, 6, 2, 4, 32, 16, 8, True),
}
RING = {  # K11 (tests/test_kernels.py, the ring 3D cases)
    "ragged_hc": (2, (5, 5, 3), 1, 8, 3, 8, 56, 16, 8, False),  # Hc = 28
    "stride1": (1, (5, 5, 3), 1, 6, 2, 4, 33, 16, 8, False),
    "taps995": (2, (9, 9, 5), 1, 8, 2, 8, 64, 16, 16, False),  # Qh = 5
    "k1": (2, (5, 5, 3), 1, 8, 1, 8, 64, 16, 8, False),        # no mid kernel
}


@pytest.fixture(scope="module", params=sorted(TILED))
def tiled_case(request):
    """One K9 forward in interpret mode (fp32 carry, with its fp32
    histories), shared by the forward and the K10 reverse comparisons."""
    s, P, C, M, K, D, H, W, band, masked = TILED[request.param]
    shape = (2, C, D, H, W)
    d = _case(s, P, C, M, K, shape, mask_shape=shape if masked else None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDLNET_HIST_DTYPE", "f32")
        x, z, hists = lista3d_tiled(*_jax(d, "yp", "A", "B", "t", "c"), stride=s,
                                    mask=_jax(d, "mask")[0], return_z=True,
                                    z_dtype=jnp.float32, interpret=True, band=band,
                                    return_hists=True)
    return d, s, x, z, hists


def test_forward_matches_k9_tiled(tiled_case):
    d, s, xj, zj, _ = tiled_case
    xt, zt = _port_forward(d, s)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4)


def test_reverse_matches_k10_tiled(tiled_case, monkeypatch):
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")
    d, s, _, _, (zh, rh) = tiled_case
    yp, A, B, t, c, mask, gx = _jax(d, "yp", "A", "B", "t", "c", "mask", "gx")
    g_ref = lista3d_tiled_fused_bwd(gx, yp, A, B, t, c, mask, zh, rh, stride=s,
                                    interpret=True)
    for name, a, b in zip("ABt", _port_grads(d, s), g_ref):
        assert _rel(a, b) <= 1e-4, name


@pytest.mark.parametrize("name", sorted(RING))
def test_forward_matches_k11_ring(name):
    s, P, C, M, K, D, H, W, band, masked = RING[name]
    shape = (2, C, D, H, W)
    d = _case(s, P, C, M, K, shape, mask_shape=shape if masked else None, seed=1)
    xj, zj = lista3d_ring(*_jax(d, "yp", "A", "B", "t", "c"), stride=s,
                          mask=_jax(d, "mask")[0], return_z=True, z_dtype=jnp.float32,
                          interpret=True, band=band)
    xt, zt = _port_forward(d, s)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4)


def test_reverse_matches_k12_ring(monkeypatch):
    """K12's masked batch case (tests/test_kernels3d_ring_bwd.py): N=2,
    per-sample c, a (1, C, 1, H, W) mask broadcast over batch and depth.
    Its z histories are laid out in row bands, so only gradients are
    compared."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")
    s, P, K, M = 2, (5, 5, 3), 3, 8
    shape = (2, 1, 8, 32, 40)
    d = _case(s, P, 1, M, K, shape, mask_shape=(1, 1, 1, 32, 40), seed=2)
    yp, A, B, t, c, mask, gx = _jax(d, "yp", "A", "B", "t", "c", "mask", "gx")
    _, _, (zh, rh) = lista3d_ring(yp, A, B, t, c, stride=s, mask=mask, return_z=False,
                                  z_dtype=jnp.float32, interpret=True, return_hists=True)
    g_ref = lista3d_ring_fused_bwd(gx, yp, A, B, t, c, mask, zh, rh, stride=s,
                                   interpret=True)
    for name, a, b in zip("ABt", _port_grads(d, s), g_ref):
        assert _rel(a, b) <= 1e-4, name


SMALL = dict(K=3, M=8, P=(5, 5, 3), s=2, C=1, adaptive=True, depth=4)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_apply_with_codes_matches_jax(backend):
    """(xhat, z, codes) of CDLNetVideo.apply_with_codes against JAX's on
    an odd-sized clip with per-sample sigma: codes[k] is every
    iteration's z_k; on "pallas" they are the kernel loop's fp32
    histories (the plain versions here)."""
    jm = JaxCDLNetVideo(**SMALL)
    d = _case(2, SMALL["P"], 1, SMALL["M"], SMALL["K"], (1, 1, 4, 8, 8), seed=4)
    params = {k: d[k] for k in "ABt"}
    rng = np.random.default_rng(3)
    y = rng.uniform(size=(2, 1, 7, 18, 22)).astype(np.float32)
    sigma = np.array([15.0, 35.0], np.float32)
    xj, zj, cj = jm.apply_with_codes(params, jnp.asarray(y), jnp.asarray(sigma))
    model = load_jax_params(CDLNetVideo(**SMALL, backend=backend), params)
    with torch.inference_mode():
        xt, zt, ct = model.apply_with_codes(torch.from_numpy(y), torch.from_numpy(sigma))
    assert ct.shape == cj.shape == (3, 2, 8, 4, 9, 11)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    torch.testing.assert_close(ct[-1], zt, rtol=0, atol=0)


def test_apply_with_codes_on_the_kernels_raises_under_grad():
    model = CDLNetVideo(**SMALL, backend="pallas").init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="return_z"):
        model.apply_with_codes(torch.zeros(1, 1, 4, 8, 8), 25.0)
