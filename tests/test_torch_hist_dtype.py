"""The bf16 training histories of cdlnet_tpu_torch (kernels/lista3d.py::
hist_dtype, bf16 by default as in the JAX package) on the CPU, at the JAX
package's own test shapes, against the JAX package in interpret mode: the
dtype's selection rules, the forward's primal (bitwise the fp32 mode's),
its bf16 z and r histories, and the gradients of the 2D and 3D
soft-threshold training paths.

JAX's contract compared here is its resident one (the 2D kernel, and the 3D
resident-history route, which each test asserts): the iteration runs in
fp32 and only the stored copies round to bf16. Inputs come from numpy
seeds and go to both packages."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu.kernels.autodiff import hist3d_dtype as jax_hist3d_dtype
from cdlnet_tpu.kernels.autodiff import lista2d_fused_diff as jax_lista2d_fused_diff
from cdlnet_tpu.kernels.autodiff import lista3d_fused_diff as jax_lista3d_fused_diff
from cdlnet_tpu.kernels.lista2d import hist_dtype as jax_hist_dtype
from cdlnet_tpu.kernels.lista2d import lista2d_fused as jax_lista2d_fused
from cdlnet_tpu.kernels.lista3d import lista3d_fused as jax_lista3d_fused
from cdlnet_tpu.kernels.lista3d import lista3d_hist_forward_path

from cdlnet_tpu_torch.kernels import autodiff
from cdlnet_tpu_torch.kernels import lista2d as L2
from cdlnet_tpu_torch.kernels import lista3d as L
from cdlnet_tpu_torch.kernels.autodiff import lista2d_fused_diff, lista3d_fused_diff

ENV = ("CDLNET_HIST_DTYPE", "CDLNET_LISTA3D_HIST_DTYPE")
# JAX's test shapes: tests/test_kernels.py's bf16 history tests
CASE_2D = dict(s=2, P=7, C=1, M=8, K=4, shape=(2, 16, 16))
CASE_3D = dict(s=2, P=(5, 5, 3), M=6, K=2, shape=(1, 1, 8, 16, 16))
PRIMAL_TOL = 1e-5   # the port's primal vs JAX's: fp32 sums in other orders
GRAD_JAX_TOL = 1e-2  # bf16 gradients, port vs JAX: max|d| / max|ref|
GRAD_F32_TOL = 1e-1  # bf16 vs fp32 gradients of the port: JAX's own bf16 gate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _default_dtype(monkeypatch):
    """Each test starts from the default (neither variable set)."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - 7)


def _ulp_report(got, want):
    """(elements that differ, elements more than one bf16 ulp apart) of two
    bf16 histories given as fp32 arrays."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    return int((diff > 0).sum()), int((diff > ulp).sum())


# --- (1) the dtype's selection rules, as JAX's hist_dtype reads them ---

@pytest.mark.parametrize("env,value,want", [
    (None, None, torch.bfloat16),
    ("CDLNET_HIST_DTYPE", "f32", torch.float32),
    ("CDLNET_HIST_DTYPE", "fp32", torch.float32),
    ("CDLNET_HIST_DTYPE", "float32", torch.float32),
    ("CDLNET_HIST_DTYPE", "bf16", torch.bfloat16),
    ("CDLNET_HIST_DTYPE", "float16", torch.bfloat16),
    ("CDLNET_LISTA3D_HIST_DTYPE", "f32", torch.float32),
    ("CDLNET_LISTA3D_HIST_DTYPE", "fp32", torch.float32),
    ("CDLNET_LISTA3D_HIST_DTYPE", "float32", torch.float32),
])
def test_hist_dtype_follows_the_jax_rules(env, value, want, monkeypatch):
    if env is not None:
        monkeypatch.setenv(env, value)
    assert L.hist_dtype() == want
    assert L2.hist_dtype() == autodiff.hist3d_dtype() == want
    jax_want = jnp.float32 if want == torch.float32 else jnp.bfloat16
    assert jax_hist_dtype() == jax_hist3d_dtype() == jax_want


def test_the_main_variable_wins_over_the_alias(monkeypatch):
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "bf16")
    monkeypatch.setenv("CDLNET_LISTA3D_HIST_DTYPE", "f32")
    assert L.hist_dtype() == torch.bfloat16
    assert jax_hist_dtype() == jnp.bfloat16


# --- (2) 2D: the primal, the histories and the gradients ---

def _inputs(P, C, M, K, shape, dims, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    Ps = (P,) * dims if isinstance(P, int) else tuple(P)
    N = shape[0]
    return dict(
        yp=0.3 * f(*shape), A=0.1 * f(K, M, C, *Ps), B=0.1 * f(K, M, C, *Ps),
        t=0.02 * np.abs(f(K, 2, M, *(1,) * dims)),
        c=np.linspace(0.1, 0.3, N, dtype=np.float32).reshape(N, *(1,) * (dims + 1)),
        mask=(rng.uniform(size=shape) > 0.5).astype(np.float32),
        tgt=rng.uniform(size=shape).astype(np.float32))


def _port_loss_grads(fused_diff, d, s, mask):
    A, B, t = (torch.from_numpy(d[k]).requires_grad_() for k in "ABt")
    x = fused_diff(torch.from_numpy(d["yp"]), A, B, t, torch.from_numpy(d["c"]), stride=s,
                   mask=None if mask is None else torch.from_numpy(mask))
    loss = torch.mean((x - torch.from_numpy(d["tgt"])) ** 2)
    return float(loss.detach()), [g.numpy() for g in torch.autograd.grad(loss, (A, B, t))]


def _jax_grads(fused_diff, d, s, mask):
    def loss(A, B, t):
        x = fused_diff(jnp.asarray(d["yp"]), A, B, t, jnp.asarray(d["c"]), stride=s,
                       mask=None if mask is None else jnp.asarray(mask), interpret=True)
        return jnp.mean((x - jnp.asarray(d["tgt"])) ** 2)

    _, g = jax.value_and_grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(d[k]) for k in "ABt"))
    return [np.asarray(a) for a in g]


@pytest.fixture(scope="module", params=[False, True], ids=["unmasked", "masked"])
def case_2d(request):
    """The 2D case run once for the module, both packages at the default
    (bf16) and the port in fp32 too."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ENV:
            mp.delenv(name, raising=False)
        c = CASE_2D
        d = _inputs(c["P"], c["C"], c["M"], c["K"], (c["shape"][0], c["C"], *c["shape"][1:]),
                    2, seed=7)
        mask = d["mask"] if request.param else None
        ops_j = [jnp.asarray(d[k]) for k in ("yp", "A", "B", "t", "c")]
        xj, _, hj = jax_lista2d_fused(*ops_j, stride=c["s"],
                                      mask=None if mask is None else jnp.asarray(mask),
                                      interpret=True, return_hist=True)
        ops_t = [torch.from_numpy(d[k]) for k in ("yp", "A", "B", "t", "c")]
        mask_t = None if mask is None else torch.from_numpy(mask)
        xb, zb, hb = L2.lista2d_fused(*ops_t, stride=c["s"], mask=mask_t, return_z=True,
                                      return_hist=True)
        xf, zf, hf = L2.lista2d_fused(*ops_t, stride=c["s"], mask=mask_t, return_z=True,
                                      return_hist=True, hists_dtype=torch.float32)
        gj = _jax_grads(jax_lista2d_fused_diff, d, c["s"], mask)
        loss_b, gb = _port_loss_grads(lista2d_fused_diff, d, c["s"], mask)
        mp.setenv("CDLNET_HIST_DTYPE", "f32")
        loss_f, gf = _port_loss_grads(lista2d_fused_diff, d, c["s"], mask)
    return dict(xj=np.asarray(xj), hj=np.asarray(hj.astype(jnp.float32)), hj_dtype=hj.dtype,
                xb=xb, zb=zb, hb=hb, xf=xf, zf=zf, hf=hf, gj=gj, gb=gb, gf=gf,
                loss_b=loss_b, loss_f=loss_f)


def test_2d_primal_is_the_f32_modes_and_jaxs(case_2d):
    r = case_2d
    assert torch.equal(r["xb"], r["xf"]) and torch.equal(r["zb"], r["zf"])
    assert r["loss_b"] == r["loss_f"]
    np.testing.assert_allclose(r["xb"].numpy(), r["xj"], atol=PRIMAL_TOL)


def test_2d_histories_are_bf16_and_match_jax(case_2d, record_property):
    r = case_2d
    zh, rh = r["hb"]
    c = CASE_2D
    K, M, N = c["K"], c["M"], c["shape"][0]
    Hc, Wc = c["shape"][1] // c["s"], c["shape"][2] // c["s"]
    assert r["hj_dtype"] == jnp.bfloat16
    assert zh.dtype == rh.dtype == torch.bfloat16
    assert r["hf"][0].dtype == torch.float32
    # the stored copies are the fp32 mode's histories rounded to nearest even
    assert torch.equal(zh, r["hf"][0].to(torch.bfloat16))
    assert torch.equal(rh, r["hf"][1].to(torch.bfloat16))
    # JAX: (N, K, Mp8 + Rp8, Hc*Wc), z_k in rows [0:M), r_k in [Mp8:Mp8+Cp)
    hj = r["hj"].reshape(N, K, -1, Hc, Wc).transpose(1, 0, 2, 3, 4)
    Cp = c["C"] * c["s"] ** 2
    for name, got, want in (("z", zh.float().numpy(), hj[:, :, :M]),
                            ("r", rh.float().numpy(), hj[1:, :, 8:8 + Cp])):
        differ, past_ulp = _ulp_report(got, want)
        record_property(f"{name}_hist_differing", f"{differ} of {got.size}")
        assert past_ulp == 0, (name, differ, past_ulp)


def test_2d_gradients_match_jax_and_the_f32_mode(case_2d, record_property):
    r = case_2d
    for name, b, j, f in zip("ABt", r["gb"], r["gj"], r["gf"]):
        to_jax, to_f32 = _rel(b, j), _rel(b, f)
        record_property(f"d{name}", f"vs JAX bf16 {to_jax:.3e}, vs port f32 {to_f32:.3e}")
        assert to_jax <= GRAD_JAX_TOL, (name, to_jax)
        assert to_f32 <= GRAD_F32_TOL, (name, to_f32)


# --- (3) 3D: the same at JAX's 3D test shape, on its resident route ---

@pytest.fixture(scope="module")
def case_3d():
    with pytest.MonkeyPatch.context() as mp:
        for name in ENV:
            mp.delenv(name, raising=False)
        c = CASE_3D
        d = _inputs(c["P"], 1, c["M"], c["K"], c["shape"], 3, seed=3)
        d["c"] = np.full((c["shape"][0], 1, 1, 1, 1), 0.1, np.float32)
        ops_j = [jnp.asarray(d[k]) for k in ("yp", "A", "B", "t", "c")]
        xj, _, (zj, rj) = jax_lista3d_fused(*ops_j, stride=c["s"], return_z=False,
                                            z_dtype=jax_hist3d_dtype(), interpret=True,
                                            return_hists=True)
        ops_t = [torch.from_numpy(d[k]) for k in ("yp", "A", "B", "t", "c")]
        xb, zb, hb = L.lista3d_fused(*ops_t, stride=c["s"], return_hists=True)
        xf, zf, hf = L.lista3d_fused(*ops_t, stride=c["s"], return_hists=True,
                                     hists_dtype=torch.float32)
        gj = _jax_grads(jax_lista3d_fused_diff, d, c["s"], None)
        loss_b, gb = _port_loss_grads(lista3d_fused_diff, d, c["s"], None)
        mp.setenv("CDLNET_HIST_DTYPE", "f32")
        loss_f, gf = _port_loss_grads(lista3d_fused_diff, d, c["s"], None)
    return dict(xj=np.asarray(xj), zj=np.asarray(zj.astype(jnp.float32)), zj_dtype=zj.dtype,
                rj=np.asarray(rj.astype(jnp.float32)), xb=xb, zb=zb, hb=hb, xf=xf, zf=zf,
                hf=hf, gj=gj, gb=gb, gf=gf, loss_b=loss_b, loss_f=loss_f)


def test_3d_case_is_on_jaxs_resident_route():
    c = CASE_3D
    N, C, D, H, W = c["shape"]
    assert lista3d_hist_forward_path(c["M"], C, c["P"], c["s"], c["K"], D, H, W,
                                     hist_bytes=2) == "resident"


def test_3d_primal_is_the_f32_modes_and_jaxs(case_3d):
    r = case_3d
    assert torch.equal(r["xb"], r["xf"]) and torch.equal(r["zb"], r["zf"])
    assert r["loss_b"] == r["loss_f"]
    np.testing.assert_allclose(r["xb"].numpy(), r["xj"], atol=PRIMAL_TOL)


def test_3d_histories_are_bf16_and_match_jax(case_3d, record_property):
    r = case_3d
    zh, rh = r["hb"]
    c = CASE_3D
    K, M = c["K"], c["M"]
    N, _, D, H, W = c["shape"]
    Dc, Hc, Wc = D // c["s"], H // c["s"], W // c["s"]
    assert r["zj_dtype"] == jnp.bfloat16
    assert zh.dtype == rh.dtype == torch.bfloat16
    assert torch.equal(zh, r["hf"][0].to(torch.bfloat16))
    assert torch.equal(rh, r["hf"][1].to(torch.bfloat16))
    # JAX keeps (K, N, Dc, ch, Hc*Wc) with the code channels padded to 8
    zj = r["zj"][:, :, :, :M].reshape(K, N, Dc, M, Hc, Wc).transpose(0, 1, 3, 2, 4, 5)
    rj = r["rj"].reshape(K - 1, N, Dc, 8, Hc, Wc).transpose(0, 1, 3, 2, 4, 5)
    for name, got, want in (("z", zh.float().numpy(), zj), ("r", rh.float().numpy(), rj)):
        differ, past_ulp = _ulp_report(got, want)
        record_property(f"{name}_hist_differing", f"{differ} of {got.size}")
        assert past_ulp == 0, (name, differ, past_ulp)


def test_3d_gradients_match_jax_and_the_f32_mode(case_3d, record_property):
    r = case_3d
    for name, b, j, f in zip("ABt", r["gb"], r["gj"], r["gf"]):
        to_jax, to_f32 = _rel(b, j), _rel(b, f)
        record_property(f"d{name}", f"vs JAX bf16 {to_jax:.3e}, vs port f32 {to_f32:.3e}")
        assert to_jax <= GRAD_JAX_TOL, (name, to_jax)
        assert to_f32 <= GRAD_F32_TOL, (name, to_f32)


# --- (4) the pieces: the CPU writers' copies, the readers' upcasts, CSR ---

def test_plain_writers_store_the_rounded_copy():
    rng = np.random.default_rng(0)
    geom = L.Geom(2, (5, 5, 3), (2, 2, 1))
    wa = L.prep_A2m_3d(torch.from_numpy(0.1 * rng.standard_normal((1, 6, 1, 5, 5, 3))
                                        .astype(np.float32)), 2, geom.pads)[0]
    r = torch.from_numpy(rng.standard_normal((1, 8, 4, 8, 8)).astype(np.float32))
    tau = torch.full((1, 6), 0.05)
    hist = torch.empty((1, 6, 4, 8, 8), dtype=torch.bfloat16)
    z = L.lista3d_ana_threshold(r, None, wa, tau, geom, hist=hist)
    assert z.dtype == torch.float32 and torch.equal(hist, z.to(torch.bfloat16))


@pytest.mark.parametrize("env,want", [(None, torch.bfloat16), ("f32", torch.float32)])
@pytest.mark.parametrize("two_sided", [False, True], ids=["csr", "csrf2"])
def test_csr_modes_store_at_hist_dtype(env, want, two_sided, monkeypatch):
    """The CSR prox modes store their z, r and u histories at hist_dtype():
    bf16 by default, fp32 under CDLNET_HIST_DTYPE=f32, the codes and output
    the same either way."""
    rng = np.random.default_rng(1)
    d = _inputs(7, 1, 8, 3, (1, 1, 16, 16), 2, seed=1)
    ops = [torch.from_numpy(d[k]) for k in ("yp", "A", "B", "t", "c")]
    f = lambda: torch.from_numpy(rng.standard_normal((1, 8, 8, 8)).astype(np.float32))
    kw = dict(g=torch.full((3, 2, 8, 1, 1), 0.1), z_prev=f())
    if two_sided:
        kw.update(g2=torch.full((3, 2, 8, 1, 1), 0.2), z_after=f())
    x0, z0 = L2.lista2d_fused(*ops, stride=2, return_z=True, **kw)
    if env is not None:
        monkeypatch.setenv("CDLNET_HIST_DTYPE", env)
    x, z, hists = L2.lista2d_fused(*ops, stride=2, return_z=True, return_hist=True, **kw)
    assert L2.hist_dtype() == want
    assert [h.dtype for h in hists] == [want] * 3
    assert torch.equal(x, x0) and torch.equal(z, z0)
