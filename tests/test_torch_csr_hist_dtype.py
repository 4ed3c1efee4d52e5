"""The CSR models' bf16 training histories in cdlnet_tpu_torch
(autodiff.csr_fused_2d_train at kernels/lista3d.py::hist_dtype, bf16 by
default) on the CPU against the JAX package's csr_fused_2d_train in
interpret mode at its bf16 default, in the four prox modes the CSR models
dispatch (the first frame's soft threshold, z_prev, z_after alone, both
codes), at the shapes of tests/test_torch_csr_train.py::_fused_inputs.

The contract held is JAX's resident one: the iteration runs in fp32 and
only the stored copies of z_k, u_k (the prox argument) and r_k round to
bf16, so the primal is bitwise the port's f32 mode's; the reverse
recomputes every prox branch from the stored bf16 u_k. Where bf16 u_k and
fp32 u_k fall in different branches of the prox, the gradients differ by
design: such codes are counted and recorded, not hidden. Inputs come from
numpy seeds and go to both packages."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu.kernels.autodiff import csr_fused_2d_train as jax_csr_fused_2d_train
from cdlnet_tpu.kernels.lista2d import hist_dtype as jax_hist_dtype
from cdlnet_tpu.kernels.lista2d import lista2d_bwd_supported, lista2d_fused_supported
from cdlnet_tpu.kernels.lista2d import lista2d_fused as jax_lista2d_fused

from cdlnet_tpu_torch.kernels import lista2d as L2
from cdlnet_tpu_torch.kernels.autodiff import csr_fused_2d_train
from cdlnet_tpu_torch.kernels.lista2d_bwd import csr_prox_branches

ENV = ("CDLNET_HIST_DTYPE", "CDLNET_LISTA3D_HIST_DTYPE")
K, M, N, H, P, S = 3, 8, 2, 32, 7, 2  # _fused_inputs' shapes
Cp, MP8, RP8 = S * S, 8, 8            # JAX's packed history rows
PRIMAL_TOL = 1e-4     # the port's primal vs JAX's (max|d| / max|ref|), as in fp32
GRAD_JAX_TOL = 1e-2   # bf16 gradients, port vs JAX
GRAD_F32_TOL = 1e-1   # the port's bf16 vs fp32 gradients: JAX's own bf16 gate
MODES = {"st": (), "z_prev": ("g", "z_prev"), "z_after": ("g2", "z_after"),
         "both": ("g", "z_prev", "g2", "z_after")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0):
    """tests/test_torch_csr_train.py::_fused_inputs: K=3, M=8, P=7, s=2,
    N=2 at 32^2, per-image sigma, positive thresholds and gamma banks,
    sparse neighbour codes, cotangents of x and z."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    ops = dict(yp=0.3 * f(N, 1, H, H), A=0.1 * f(K, M, 1, P, P), B=0.1 * f(K, M, 1, P, P),
               t=0.02 * np.abs(f(K, 2, M, 1, 1)),
               c=np.array([20 / 255, 30 / 255], np.float32).reshape(N, 1, 1, 1))
    zp = f(N, M, H // 2, H // 2)
    codes = dict(z_prev=np.where(np.abs(zp) < 0.5, 0, zp).astype(np.float32),
                 z_after=0.3 * f(N, M, H // 2, H // 2),
                 g=0.5 * np.abs(f(K, 2, M, 1, 1)), g2=0.5 * np.abs(f(K, 2, M, 1, 1)))
    cot = (f(N, 1, H, H), f(N, M, H // 2, H // 2))
    return ops, codes, cot


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - 7)


def _past_one_ulp(got, want):
    """(elements that differ, elements more than one bf16 ulp apart)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    return int((diff > 0).sum()), int((diff > _bf16_ulp(np.maximum(np.abs(got),
                                                                    np.abs(want)))).sum())


def _prox_operands(codes, ops, k):
    """(zp, za, tau, g1, g2) of iteration k for csr_prox_branches: the
    one-sided modes (z_after alone with g2) with za None."""
    c = torch.from_numpy(ops["c"]).reshape(N, 1)
    bank = lambda b: (torch.from_numpy(b[k, 0, :, 0, 0])
                      + c * torch.from_numpy(b[k, 1, :, 0, 0]))[:, :, None, None]
    tau = bank(ops["t"])
    if "z_prev" in codes and "z_after" in codes:
        return (torch.from_numpy(codes["z_prev"]), torch.from_numpy(codes["z_after"]), tau,
                bank(codes["g"]), bank(codes["g2"]))
    name, gname = ("z_prev", "g") if "z_prev" in codes else ("z_after", "g2")
    return torch.from_numpy(codes[name]), None, tau, bank(codes[gname]), None


def _flips(u_a, u_b, codes, ops):
    """(N, M, Hc, Wc) bool: the codes whose prox branch differs between two
    u histories at some iteration."""
    return torch.stack([(csr_prox_branches(u_a[k], *_prox_operands(codes, ops, k))
                         != csr_prox_branches(u_b[k], *_prox_operands(codes, ops, k))).any(0)
                        for k in range(K)]).any(0).numpy()


def _rel_kept(got, want, flipped):
    """_rel over the codes that no iteration flips."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want)[~flipped].max() / max(np.abs(want).max(), 1e-30))


def _port(ops, codes, cot, names, diff):
    """x, z and the gradients of csr_fused_2d_train at the current
    CDLNET_HIST_DTYPE, and the loop's histories at that dtype."""
    leaves = {n: torch.from_numpy(diff[n]).requires_grad_() for n in names}
    kw = {n: leaves[n] for n in names[3:]}
    x, z = csr_fused_2d_train(torch.from_numpy(ops["yp"]), leaves["A"], leaves["B"],
                              leaves["t"], torch.from_numpy(ops["c"]), stride=S, **kw)
    grads = torch.autograd.grad([x, z], [leaves[n] for n in names],
                                [torch.from_numpy(a) for a in cot])
    fused = [torch.from_numpy(ops[k]) for k in ("yp", "A", "B", "t", "c")]
    _, _, hists = L2.lista2d_fused(*fused, stride=S, return_z=True, return_hist=True,
                                   **{n: torch.from_numpy(codes[n]) for n in names[3:]})
    return x.detach(), z.detach(), [g.numpy() for g in grads], hists


@pytest.fixture(scope="module", params=list(MODES))
def case(request):
    """One prox mode run once: JAX at its default (bf16), the port at its
    default and under CDLNET_HIST_DTYPE=f32."""
    mode = request.param
    ops, codes, (dx, dz) = _inputs()
    names = ("A", "B", "t") + MODES[mode]
    diff = {k: ops[k] for k in ("A", "B", "t")} | {k: codes[k] for k in MODES[mode]}
    with pytest.MonkeyPatch.context() as mp:
        for name in ENV:
            mp.delenv(name, raising=False)
        assert jax_hist_dtype() == jnp.bfloat16 and L2.hist_dtype() == torch.bfloat16

        def jf(*vals):
            kw = dict(zip(names, vals))
            return jax_csr_fused_2d_train(jnp.asarray(ops["yp"]), kw.pop("A"), kw.pop("B"),
                                          kw.pop("t"), jnp.asarray(ops["c"]), stride=S,
                                          interpret=True, **kw)

        (xj, zj), vjp = jax.vjp(jf, *(jnp.asarray(diff[n]) for n in names))
        gj = [np.asarray(g) for g in vjp((jnp.asarray(dx), jnp.asarray(dz)))]
        jops = [jnp.asarray(ops[k]) for k in ("yp", "A", "B", "t", "c")]
        _, _, hj = jax_lista2d_fused(*jops, stride=S, return_z=True, return_hist=True,
                                     interpret=True,
                                     **{n: jnp.asarray(codes[n]) for n in MODES[mode]})
        bf = _port(ops, codes, (dx, dz), names, diff)
        mp.setenv("CDLNET_HIST_DTYPE", "f32")
        f32 = _port(ops, codes, (dx, dz), names, diff)
    return dict(mode=mode, ops=ops, codes={n: codes[n] for n in MODES[mode]}, names=names,
                xj=np.asarray(xj), zj=np.asarray(zj), gj=gj, hj_dtype=hj.dtype,
                hj=np.asarray(hj.astype(jnp.float32)), bf=bf, f32=f32)


@pytest.mark.parametrize("mode", list(MODES))
def test_jax_routes_this_case_to_csr_fused_2d_train(mode):
    """The shapes are on JAX's fused CSR training route (models/csr.py
    picks csr_fused_2d_train where both kernels fit)."""
    n_codes = len(MODES[mode]) // 2
    assert lista2d_fused_supported(M, 1, P, S, K, H, H, return_z=True, n_codes=n_codes,
                                   hist=True)
    assert lista2d_bwd_supported(M, 1, P, S, K, H, H, n_codes=n_codes)


def test_primal_is_the_f32_modes_and_jaxs(case):
    (xb, zb, _, _), (xf, zf, _, _) = case["bf"], case["f32"]
    assert torch.equal(xb, xf) and torch.equal(zb, zf)
    assert _rel(xb, case["xj"]) <= PRIMAL_TOL and _rel(zb, case["zj"]) <= PRIMAL_TOL


def test_histories_are_bf16_and_match_jax(case, record_property):
    """z_k, u_k and r_k: bf16, the f32 mode's histories rounded to nearest
    even, and within one bf16 ulp of JAX's packed rows (z_k in [0:M), u_k
    in [Mp8:Mp8+M) in a CSR mode, r_k after them)."""
    hb, hf = case["bf"][3], case["f32"][3]
    csr = case["mode"] != "st"
    assert case["hj_dtype"] == jnp.bfloat16
    assert len(hb) == len(hf) == (3 if csr else 2)
    assert all(h.dtype == torch.bfloat16 for h in hb)
    assert all(h.dtype == torch.float32 for h in hf)
    assert all(torch.equal(b, f.to(torch.bfloat16)) for b, f in zip(hb, hf))
    hj = case["hj"].reshape(N, K, -1, H // S, H // S).transpose(1, 0, 2, 3, 4)
    r0 = 2 * MP8 if csr else MP8
    want = {"z": hj[:, :, :M], "r": hj[1:, :, r0:r0 + Cp]}
    got = {"z": hb[0], "r": hb[1]}
    if csr:
        want["u"], got["u"] = hj[:, :, MP8:MP8 + M], hb[2]
    for name in got:
        differ, past = _past_one_ulp(got[name].float().numpy(), want[name])
        record_property(f"{name}_hist_differing", f"{differ} of {want[name].size}")
        assert past == 0, (name, differ, past)


def test_gradients_match_jax_and_the_f32_mode(case, record_property):
    """A, B, t and the gamma banks within 1e-2 of JAX's bf16 gradients and
    1e-1 of the port's f32 ones; the carried codes' gradients the same,
    over the codes whose prox branch is the same in the two u histories
    compared. A code's cotangent is elementwise: where bf16 u_k falls in
    another branch than fp32 u_k (or JAX's bf16 u_k), that code's gradient
    moves by the whole local gradient, by design. Those codes are counted,
    recorded and set apart; at these shapes the port's and JAX's bf16
    histories flip none."""
    gb, gf = case["bf"][2], case["f32"][2]
    flips = {}
    if case["mode"] != "st":
        ub, uf = case["bf"][3][2], case["f32"][3][2]
        hj = case["hj"].reshape(N, K, -1, H // S, H // S).transpose(1, 0, 2, 3, 4)
        uj = torch.from_numpy(np.ascontiguousarray(hj[:, :, MP8:MP8 + M]))
        flips = {"jax": _flips(ub, uj, case["codes"], case["ops"]),
                 "f32": _flips(ub, uf, case["codes"], case["ops"])}
        for other, mask in flips.items():
            record_property(f"branch_flips_bf16_vs_{other}", f"{int(mask.sum())} of {mask.size}")
        assert not flips["jax"].any()
    for name, b, j, f in zip(case["names"], gb, case["gj"], gf):
        if name.startswith("z_"):
            to_jax, to_f32 = _rel_kept(b, j, flips["jax"]), _rel_kept(b, f, flips["f32"])
        else:
            to_jax, to_f32 = _rel(b, j), _rel(b, f)
        record_property(f"d{name}", f"vs JAX bf16 {to_jax:.3e}, vs port f32 {to_f32:.3e}")
        assert to_jax <= GRAD_JAX_TOL, (name, to_jax)
        assert to_f32 <= GRAD_F32_TOL, (name, to_f32)
