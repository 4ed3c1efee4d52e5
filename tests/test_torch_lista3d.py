"""cdlnet_tpu_torch/kernels/lista3d.py on the CPU: the kernels' plain
versions against a direct strided-conv LISTA step, and the fused forward
against the JAX package's Pallas kernel (interpret mode) and XLA scan."""

import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cdlnet_tpu.kernels.lista3d import lista3d_fused as jax_lista3d_fused
from cdlnet_tpu.ops.conv import conv_transpose3d as jax_conv_transpose3d
from cdlnet_tpu.ops.lista import lista_3d as jax_lista_3d
from cdlnet_tpu_torch.core.ops import ST
from cdlnet_tpu_torch.kernels import _build
from cdlnet_tpu_torch.kernels import lista3d as L
from cdlnet_tpu_torch.kernels import lista3d_bwd as LB
from cdlnet_tpu_torch.ops import polyphase as pp
from cdlnet_tpu_torch.ops.conv import conv3d, conv_transpose3d


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


K, M, S, SHAPE = 3, 13, 2, (2, 1, 8, 16, 16)


def _inputs(P, seed=0, K=K, M=M, shape=SHAPE):
    """Seeded numpy inputs shared by both packages; c differs per sample."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    yp = 0.3 * f(*shape)
    A = 0.1 * f(K, M, shape[1], *P)
    B = 0.1 * f(K, M, shape[1], *P)
    t = 0.02 * np.abs(f(K, 2, M, 1, 1, 1))
    c = np.array([0.1, 0.2], np.float32).reshape(2, 1, 1, 1, 1)
    mask = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    return yp, A, B, t, c, mask


def _geom(P, s):
    pads = tuple(p // 2 for p in P)
    return pads, L.Geom(s, P, pads)


@pytest.mark.parametrize("P,s", [((7, 7, 5), 2), ((5, 5, 3), 2), ((5, 5, 3), 1)])
def test_ana_threshold_plain_is_one_strided_analysis(P, s):
    yp, A, B, t, c, mask = map(torch.from_numpy, _inputs(P))
    pads, geom = _geom(P, s)
    tau = t[1, 0] + c * t[1, 1]  # (N, M, 1, 1, 1)
    z0 = ST(conv3d(yp, A[0], stride=s, padding=pads), tau)
    r = mask * conv_transpose3d(z0, B[1], stride=s, padding=pads,
                                output_padding=s - 1) - yp
    want = ST(z0 - conv3d(r, A[1], stride=s, padding=pads), tau)
    got = L.lista3d_ana_threshold_plain(
        pp.space_to_depth(r, s, 3), z0, L.prep_A2m_3d(A, s, pads)[1],
        tau.reshape(2, M), geom)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    first = L.lista3d_ana_threshold_plain(
        -pp.space_to_depth(yp, s, 3), None, L.prep_A2m_3d(A, s, pads)[0],
        tau.reshape(2, M), geom)
    np.testing.assert_allclose(first.numpy(), z0.numpy(), atol=1e-5)


@pytest.mark.parametrize("P,s", [((7, 7, 5), 2), ((5, 5, 3), 2), ((5, 5, 3), 1)])
@pytest.mark.parametrize("residual", [False, True])
def test_syn_residual_plain_is_one_strided_synthesis(P, s, residual):
    yp, A, B, t, c, mask = map(torch.from_numpy, _inputs(P))
    pads, geom = _geom(P, s)
    z = conv3d(yp, A[0], stride=s, padding=pads)
    Bz = conv_transpose3d(z, B[2], stride=s, padding=pads, output_padding=s - 1)
    want = mask * Bz - yp if residual else Bz
    kw = dict(mask=pp.space_to_depth(mask, s, 3), y=pp.space_to_depth(yp, s, 3)) \
        if residual else {}
    got = L.lista3d_syn_residual_plain(z, L.prep_B2m_3d(B, s, pads)[2], geom, **kw)
    np.testing.assert_allclose(pp.depth_to_space(got, s, 3, 1).numpy(),
                               want.numpy(), atol=1e-5)


@pytest.mark.parametrize("use_mask", [False, True])
def test_fused_matches_jax_pallas_interpret(use_mask):
    P = (7, 7, 5)
    yp, A, B, t, c, mask = _inputs(P)
    m = mask if use_mask else None
    xj, zj = jax_lista3d_fused(
        *map(jnp.asarray, (yp, A, B, t, c)), stride=S,
        mask=None if m is None else jnp.asarray(m),
        z_dtype=jnp.float32, interpret=True)
    xt, zt = L.lista3d_fused(*map(torch.from_numpy, (yp, A, B, t, c)), stride=S,
                             mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4)


@pytest.mark.parametrize("P,use_mask", [((7, 7, 5), False), ((7, 7, 5), True),
                                        ((5, 5, 3), True)])
def test_fused_matches_jax_scan(P, use_mask):
    yp, A, B, t, c, mask = _inputs(P, seed=1)
    m = mask if use_mask else None
    pads = tuple(p // 2 for p in P)
    zj = jax_lista_3d(*map(jnp.asarray, (yp, A, B, t, c)),
                      mask=None if m is None else jnp.asarray(m), stride=S)
    xj = jax_conv_transpose3d(zj, jnp.asarray(B[0]), stride=S, padding=pads,
                              output_padding=S - 1)
    xt, zt = L.lista3d_fused(*map(torch.from_numpy, (yp, A, B, t, c)), stride=S,
                             mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4)


def test_fused_return_z_false_and_scalar_c():
    yp, A, B, t, _, _ = map(torch.from_numpy, _inputs((5, 5, 3)))
    x, z = L.lista3d_fused(yp, A, B, t, 0.1, stride=S, return_z=False)
    x2, _ = L.lista3d_fused(yp, A, B, t, torch.full((2, 1, 1, 1, 1), 0.1), stride=S)
    assert z is None and x.shape == yp.shape
    torch.testing.assert_close(x, x2, rtol=0, atol=0)


def test_wrappers_write_into_out():
    """out= takes a slice of a preallocated history; the result is written
    there and returned, equal to a call without out."""
    yp, A, B, t, c, _ = map(torch.from_numpy, _inputs((5, 5, 3)))
    y2, _, wa, ws, tau, geom = L.phase_operands(yp, A, B, t, c, S)
    z0 = L.lista3d_ana_threshold(-y2, None, wa[0], tau[0], geom)
    hist = torch.zeros((2, *z0.shape))
    got = L.lista3d_ana_threshold(-y2, None, wa[0], tau[0], geom, out=hist[1])
    assert got.data_ptr() == hist[1].data_ptr() and torch.equal(hist[1], z0)
    r = L.lista3d_syn_residual(z0, ws[1], geom, y=y2)
    rh = torch.zeros((2, *y2.shape))
    got = L.lista3d_syn_residual(z0, ws[1], geom, y=y2, out=rh[0])
    assert got.data_ptr() == rh[0].data_ptr() and torch.equal(rh[0], r)


def test_cpu_calls_do_not_count_launches():
    L.launches.clear()
    yp, A, B, t, c, _ = map(torch.from_numpy, _inputs((5, 5, 3)))
    L.lista3d_fused(yp, A, B, t, c, stride=S)
    assert sum(L.launches.values()) == 0


@pytest.mark.parametrize("which", ["ana", "syn", "syn_adjoint", "wgrad"])
def test_non_cpu_tensor_without_library_raises(which, monkeypatch, tmp_path):
    """A tensor off the CPU never takes the plain version: with no kernel
    library to be had, the wrapper raises instead of falling back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    _build.library.cache_clear()
    try:
        meta = lambda *sh: torch.empty(*sh, device="meta")
        geom = L.Geom(2, (7, 7, 5), (3, 3, 2))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            if which == "ana":
                L.lista3d_ana_threshold(meta(1, 8, 4, 8, 8), None,
                                        meta(8, 4, 4, 3, 5), meta(1, 5), geom)
            elif which == "syn":
                L.lista3d_syn_residual(meta(1, 5, 4, 8, 8), meta(5, 4, 4, 3, 8), geom)
            elif which == "syn_adjoint":
                LB.lista3d_syn_adjoint(meta(1, 8, 4, 8, 8), meta(8, 4, 4, 3, 5),
                                       meta(1, 5, 4, 8, 8), geom)
            else:
                LB.lista3d_wgrad(meta(1, 8, 4, 8, 8), meta(1, 5, 4, 8, 8),
                                 (4, 4, 3), geom.off_a)
    finally:
        _build.library.cache_clear()


def test_library_path_tracks_sources(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    p1 = _build.library_path()
    assert p1.parent == tmp_path / "build" and p1.suffix == ".so"
    (src / "a.cu").write_text("// v2\n")
    assert _build.library_path() != p1


def _extern_c_entries():
    """{name: [(source, parameter count), ...]} of every function defined in
    an extern "C" block of kernels/csrc/*.cu."""
    found = {}
    for src in sorted(_build.SRC_DIR.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r'extern "C"\s*\{', text):
            depth, i = 1, m.end()
            while depth:
                depth += {"{": 1, "}": -1}.get(text[i], 0)
                i += 1
            body = text[m.end():i - 1]
            while re.search(r"\{[^{}]*\}", body):  # function bodies -> "@"
                body = re.sub(r"\{[^{}]*\}", "@", body)
            for f in re.finditer(r"(\w+)\s*\(([^()]*)\)\s*@", body):
                n = len([a for a in f.group(2).split(",") if a.strip()])
                found.setdefault(f.group(1), []).append((src.name, n))
    return found


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_its_c_entry(name):
    """Each entry the loader declares is defined once, in one extern "C"
    block of the sources, with as many parameters as its argtypes."""
    defs = _extern_c_entries().get(name, [])
    assert len(defs) == 1, f"{name}: defined in {defs}"
    assert defs[0][1] == len(_build.SIGNATURES[name]), f"{name}: {defs[0]}"


def test_csrc_includes_exist():
    for src in sorted(_build.SRC_DIR.glob("*.cu*")):
        for inc in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert (_build.SRC_DIR / inc).is_file(), f"{src.name} includes {inc}"
