"""The CUDA kernels of cdlnet_tpu_torch against their plain PyTorch versions,
on the GPU. Every test here needs a CUDA card and skips without one.

This file imports no jax, so it runs where jax is not installed; the
repository's conftest.py imports jax, so on such a machine run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cdlnet_tpu_torch.kernels import lista2d as L2
from cdlnet_tpu_torch.kernels import lista2d_bwd as LB2
from cdlnet_tpu_torch.kernels import lista3d as L
from cdlnet_tpu_torch.kernels import lista3d_bwd as LB
from cdlnet_tpu_torch.core.ops import ST, prox_csr, prox_csr_f2
from cdlnet_tpu_torch.kernels.autodiff import csr_fused_2d_train, lista3d_fused_diff
from cdlnet_tpu_torch.kernels.lista2d_bwd import csr_prox_branches

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(P, s, M, N, D, H, W, C=1, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    pads = tuple(p // 2 for p in P)
    geom = L.Geom(s, P, pads)
    A = 0.1 * f(1, M, C, *P)
    B = 0.1 * f(1, M, C, *P)
    wa = L.prep_A2m_3d(A, s, pads)[0]
    ws = L.prep_B2m_3d(B, s, pads)[0]
    wa_adj = LB.adjoint_bank(wa)  # A's flipped bank: the analysis adjoint
    ws_adj = LB.adjoint_bank(ws)  # B's unflipped bank: the synthesis adjoint
    Cp = C * s**3
    Dc, Hc, Wc = D // s, H // s, W // s
    r = f(N, Cp, Dc, Hc, Wc)
    z = f(N, M, Dc, Hc, Wc)
    z = torch.where(z.abs() < 0.5, torch.zeros_like(z), z)  # sparse codes
    y = f(N, Cp, Dc, Hc, Wc)
    mask = torch.from_numpy((rng.uniform(size=(N, Cp, Dc, Hc, Wc)) > 0.5).astype(np.float32))
    tau = torch.from_numpy(rng.uniform(0.0, 0.5, (N, M)).astype(np.float32))
    return dict(wa=wa, ws=ws, wa_adj=wa_adj, ws_adj=ws_adj, r=r, z=z, y=y,
                mask=mask, tau=tau, geom=geom, base=f(N, M, Dc, Hc, Wc),
                taps=tuple(wa.shape[1:4]))


SHAPES = [
    # P, s, M, N, D, H, W, C — asymmetric taps, ragged M and code-grid
    # widths, several colour channels (phase = channel % s^3)
    ((7, 7, 5), 2, 13, 2, 8, 16, 16, 1),
    ((7, 7, 5), 2, 40, 1, 16, 36, 150, 1),
    ((5, 5, 3), 2, 32, 1, 16, 128, 128, 1),
    ((5, 5, 3), 1, 9, 2, 6, 10, 70, 1),
    ((5, 5, 3), 2, 6, 1, 8, 12, 20, 3),
]


def _rel(a, b):
    return float((a.cpu() - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", SHAPES)
@pytest.mark.parametrize("first", [False, True])
def test_ana_threshold_matches_plain(cuda, P, s, M, N, D, H, W, C, first):
    d = _setup(P, s, M, N, D, H, W, C)
    z = None if first else d["z"]
    ref = L.lista3d_ana_threshold_plain(d["r"], z, d["wa"], d["tau"], d["geom"])
    got = L.lista3d_ana_threshold(
        d["r"].to(cuda), None if z is None else z.to(cuda), d["wa"].to(cuda),
        d["tau"].to(cuda), d["geom"])
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", SHAPES)
@pytest.mark.parametrize("residual", [False, True])
def test_syn_residual_matches_plain(cuda, P, s, M, N, D, H, W, C, residual):
    d = _setup(P, s, M, N, D, H, W, C)
    mask, y = (d["mask"], d["y"]) if residual else (None, None)
    ref = L.lista3d_syn_residual_plain(d["z"], d["ws"], d["geom"], mask=mask, y=y)
    got = L.lista3d_syn_residual(
        d["z"].to(cuda), d["ws"].to(cuda), d["geom"],
        mask=None if mask is None else mask.to(cuda),
        y=None if y is None else y.to(cuda))
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5


# the flagship widths of the tensor-core pair: M=169 at the serve shape (one
# 16x128^2 clip, an 8x64x64 code grid) and at the video train shape (N=2)
FLAGSHIP_SHAPES = [
    ((7, 7, 5), 2, 169, 1, 16, 128, 128, 1),
    ((7, 7, 5), 2, 169, 2, 16, 128, 128, 1),
]


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", FLAGSHIP_SHAPES)
@pytest.mark.parametrize("first", [False, True])
def test_flagship_ana_threshold_matches_plain(cuda, P, s, M, N, D, H, W, C, first):
    """Per-sample tau (N=2), the codes written into a slice of a history."""
    d = _setup(P, s, M, N, D, H, W, C)
    z = None if first else d["z"]
    ref = L.lista3d_ana_threshold_plain(d["r"], z, d["wa"], d["tau"], d["geom"])
    hist = torch.full((3, *ref.shape), float("nan"), device=cuda)
    got = L.lista3d_ana_threshold(
        d["r"].to(cuda), None if z is None else z.to(cuda), d["wa"].to(cuda),
        d["tau"].to(cuda), d["geom"], out=hist[1])
    torch.cuda.synchronize()
    assert got.data_ptr() == hist[1].data_ptr()
    assert _rel(got, ref) <= 1e-5
    assert torch.isnan(hist[0]).all() and torch.isnan(hist[2]).all()


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", FLAGSHIP_SHAPES)
@pytest.mark.parametrize("residual", ["none", "y", "mask and y"])
def test_flagship_syn_residual_matches_plain(cuda, P, s, M, N, D, H, W, C, residual):
    d = _setup(P, s, M, N, D, H, W, C)
    mask = d["mask"] if residual == "mask and y" else None
    y = None if residual == "none" else d["y"]
    ref = L.lista3d_syn_residual_plain(d["z"], d["ws"], d["geom"], mask=mask, y=y)
    hist = torch.full((3, *ref.shape), float("nan"), device=cuda)
    got = L.lista3d_syn_residual(
        d["z"].to(cuda), d["ws"].to(cuda), d["geom"],
        mask=None if mask is None else mask.to(cuda),
        y=None if y is None else y.to(cuda), out=hist[2])
    torch.cuda.synchronize()
    assert got.data_ptr() == hist[2].data_ptr()
    assert _rel(got, ref) <= 1e-5
    assert torch.isnan(hist[:2]).all()


def test_ana_threshold_in_place_matches_plain(cuda):
    """z_out may be z_old: each code is read, then written, by one thread."""
    d = _setup((7, 7, 5), 2, 169, 2, 8, 32, 96)
    ref = L.lista3d_ana_threshold_plain(d["r"], d["z"], d["wa"], d["tau"], d["geom"])
    z = d["z"].to(cuda)
    got = L.lista3d_ana_threshold(d["r"].to(cuda), z, d["wa"].to(cuda), d["tau"].to(cuda),
                                  d["geom"], out=z)
    torch.cuda.synchronize()
    assert got.data_ptr() == z.data_ptr()
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", [FLAGSHIP_SHAPES[1], SHAPES[4]])
def test_forward_kernels_are_deterministic(cuda, P, s, M, N, D, H, W, C):
    d = _setup(P, s, M, N, D, H, W, C)
    r, z, wa, ws, tau, mask, y = (d[k].to(cuda) for k in
                                  ("r", "z", "wa", "ws", "tau", "mask", "y"))
    runs = [(L.lista3d_ana_threshold(r, z, wa, tau, d["geom"]),
             L.lista3d_ana_threshold(r, None, wa, tau, d["geom"]),
             L.lista3d_syn_residual(z, ws, d["geom"], mask=mask, y=y),
             L.lista3d_syn_residual(z, ws, d["geom"]))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_fused_on_cuda_matches_cpu_and_counts_launches(cuda):
    rng = np.random.default_rng(3)
    K, M, P, s = 3, 13, (7, 7, 5), 2
    yp = torch.from_numpy(0.3 * rng.standard_normal((2, 1, 8, 16, 16)).astype(np.float32))
    A = torch.from_numpy(0.1 * rng.standard_normal((K, M, 1, *P)).astype(np.float32))
    B = torch.from_numpy(0.1 * rng.standard_normal((K, M, 1, *P)).astype(np.float32))
    t = torch.from_numpy(0.02 * np.abs(rng.standard_normal((K, 2, M, 1, 1, 1))).astype(np.float32))
    c = torch.tensor([0.1, 0.2]).reshape(2, 1, 1, 1, 1)
    mask = torch.from_numpy((rng.uniform(size=yp.shape) > 0.5).astype(np.float32))
    x_ref, z_ref = L.lista3d_fused(yp, A, B, t, c, stride=s, mask=mask)
    L.launches.clear()
    x, z = L.lista3d_fused(*(v.to(cuda) for v in (yp, A, B, t, c)), stride=s,
                           mask=mask.to(cuda))
    torch.cuda.synchronize()
    assert dict(L.launches) == {"lista3d_ana_threshold": K, "lista3d_syn_residual": K}
    np.testing.assert_allclose(x.cpu().numpy(), x_ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(z.cpu().numpy(), z_ref.numpy(), atol=1e-4)


def test_fused_histories_on_cuda_match_cpu(cuda, monkeypatch):
    """The kernels write each z_k and r_k straight into its history slice."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    rng = np.random.default_rng(5)
    K, M, P, s = 3, 13, (7, 7, 5), 2
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    yp = 0.3 * f(2, 1, 8, 16, 16)
    A, B = 0.1 * f(K, M, 1, *P), 0.1 * f(K, M, 1, *P)
    t = 0.02 * f(K, 2, M, 1, 1, 1).abs()
    c = torch.tensor([0.1, 0.2]).reshape(2, 1, 1, 1, 1)
    _, z_ref, (zh_ref, rh_ref) = L.lista3d_fused(yp, A, B, t, c, stride=s,
                                                  return_hists=True)
    _, z, (zh, rh) = L.lista3d_fused(*(v.to(cuda) for v in (yp, A, B, t, c)),
                                     stride=s, return_hists=True)
    torch.cuda.synchronize()
    assert zh.shape == zh_ref.shape and rh.shape == rh_ref.shape
    assert z.data_ptr() == zh[K - 1].data_ptr()
    for got, ref in ((zh, zh_ref), (rh, rh_ref)):
        assert _rel(got, ref) <= 1e-4


def test_fused_grad_on_cuda_matches_cpu_and_counts_launches(cuda, monkeypatch):
    """The grad-enabled kernel forward and its reverse kernels give the
    CPU reverse loop's gradients, with 2K + K + (K-1) + 2K launches."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    rng = np.random.default_rng(4)
    K, M, P, s = 3, 13, (7, 7, 5), 2
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    yp, tgt = 0.3 * f(2, 1, 8, 16, 16), f(2, 1, 8, 16, 16)
    A, B = 0.1 * f(K, M, 1, *P), 0.1 * f(K, M, 1, *P)
    t = 0.02 * f(K, 2, M, 1, 1, 1).abs()
    c = torch.tensor([0.1, 0.2]).reshape(2, 1, 1, 1, 1)
    mask = (f(*yp.shape) > 0).float()

    def grads(dev):
        prm = [v.to(dev).requires_grad_() for v in (A, B, t)]
        x = lista3d_fused_diff(yp.to(dev), *prm, c.to(dev), stride=s, mask=mask.to(dev))
        loss = ((x - tgt.to(dev)) ** 2).mean()
        return [g.cpu() for g in torch.autograd.grad(loss, prm)]

    want = grads("cpu")
    L.launches.clear()
    got = grads(cuda)
    assert dict(L.launches) == {"lista3d_ana_threshold": K,
                                "lista3d_syn_residual": 2 * K - 1,
                                "lista3d_syn_adjoint": K, "lista3d_wgrad": 2 * K}
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4


# the reverse kernels' further shapes: a 427-wide code grid (the native
# 854-wide frame: ragged 64-column stages), one phase channel (Cp = 1) and
# three (stride 1, colour), and the flagship train shape's full width and
# long reduction (M = 169 codes, N = 2 clips of a 8x64x64 code grid: 65,536
# positions a weight-gradient entry)
REVERSE_SHAPES = [
    ((7, 7, 5), 2, 24, 1, 4, 20, 854, 1),
    ((5, 5, 3), 1, 12, 1, 6, 16, 40, 1),
    ((5, 5, 3), 1, 10, 1, 6, 12, 36, 3),
    ((7, 7, 5), 2, 169, 2, 16, 128, 128, 1),
]


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", SHAPES + REVERSE_SHAPES)
@pytest.mark.parametrize("with_base,alpha", [(False, 1.0), (True, -1.0), (True, 1.0)])
def test_syn_adjoint_matches_plain(cuda, P, s, M, N, D, H, W, C, with_base, alpha):
    d = _setup(P, s, M, N, D, H, W, C)
    base = d["base"] if with_base else None
    ref = LB.lista3d_syn_adjoint_plain(d["y"], d["ws_adj"], d["z"], d["geom"],
                                       base=base, alpha=alpha)
    got = LB.lista3d_syn_adjoint(
        d["y"].to(cuda), d["ws_adj"].to(cuda), d["z"].to(cuda), d["geom"],
        base=None if base is None else base.to(cuda), alpha=alpha)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel(g, r) <= 1e-5


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", SHAPES + REVERSE_SHAPES)
@pytest.mark.parametrize("form", ["dA", "dB", "dB-swapped"])
def test_wgrad_matches_plain(cuda, P, s, M, N, D, H, W, C, form):
    d = _setup(P, s, M, N, D, H, W, C)
    geom = d["geom"]
    # dA: x = r, y = dv at the analysis offsets; dB: x = z, y = g at the
    # synthesis offsets (few output channels); dB-swapped: the form the
    # reverse loop runs, x = g, y = z at the analysis offsets
    x, y, off = {"dA": (d["r"], d["z"], geom.off_a),
                 "dB": (d["z"], d["y"], geom.off_s),
                 "dB-swapped": (d["y"], d["z"], geom.off_a)}[form]
    ref = LB.lista3d_wgrad_plain(x, y, d["taps"], off, alpha=-1.0)
    got = LB.lista3d_wgrad(x.to(cuda), y.to(cuda), d["taps"], off, alpha=-1.0)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", [SHAPES[0], SHAPES[4]] + REVERSE_SHAPES)
@pytest.mark.parametrize("form", ["dA", "dB-swapped"])
def test_wgrad_on_the_phase_rows_matches_plain(cuda, P, s, M, N, D, H, W, C, form):
    """The form the reverse loop runs: only the phase rows the prep keeps,
    zeros on the others."""
    d = _setup(P, s, M, N, D, H, W, C)
    geom = d["geom"]
    rows = LB.phase_rows(geom, d["wa"].shape[0], 3)
    x = d["r"] if form == "dA" else d["y"]
    ref = LB.lista3d_wgrad_plain(x, d["z"], d["taps"], geom.off_a, alpha=-1.0, rows=rows)
    got = LB.lista3d_wgrad(x.to(cuda), d["z"].to(cuda), d["taps"], geom.off_a, alpha=-1.0,
                           rows=rows)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5
    assert not got.cpu()[~rows].any()


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", [SHAPES[1], REVERSE_SHAPES[0]])
def test_reverse_kernels_on_operands_off_the_grid_match_plain(cuda, P, s, M, N, D, H, W, C):
    """Every operand 4 bytes off the 16-byte grid, as history slices of an
    odd-sized code grid sit: the staging keeps each row's offset and the
    adjoint's epilogue goes scalar."""
    d = _setup(P, s, M, N, D, H, W, C)
    geom, taps = d["geom"], d["taps"]
    y, z, r, base, ws_adj = (_off_grid(d[k], cuda) for k in ("y", "z", "r", "base", "ws_adj"))
    assert z.data_ptr() % 16 == 4
    ref = LB.lista3d_syn_adjoint_plain(d["y"], d["ws_adj"], d["z"], geom, base=d["base"],
                                       alpha=-1.0)
    got = LB.lista3d_syn_adjoint(y, ws_adj, z, geom, base=base, alpha=-1.0)
    torch.cuda.synchronize()
    for g, rf in zip(got, ref):
        assert _rel(g, rf) <= 1e-5
    rows = LB.phase_rows(geom, d["wa"].shape[0], 3)
    for x, xc in ((d["r"], r), (d["y"], y)):
        for kw in ({}, {"rows": rows}):
            ref = LB.lista3d_wgrad_plain(x, d["z"], taps, geom.off_a, alpha=-1.0, **kw)
            got = LB.lista3d_wgrad(xc, z, taps, geom.off_a, alpha=-1.0, **kw)
            torch.cuda.synchronize()
            assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("off_grid", [False, True])
def test_reverse_kernels_are_deterministic(cuda, off_grid):
    d = _setup((7, 7, 5), 2, 169, 2, 16, 128, 128)
    put = (lambda t: _off_grid(t, cuda)) if off_grid else (lambda t: t.to(cuda))
    z, r, y = put(d["z"]), put(d["r"]), put(d["y"])
    ws_adj = d["ws_adj"].to(cuda)
    rows = LB.phase_rows(d["geom"], d["wa"].shape[0], 3)
    runs = [(LB.lista3d_wgrad(r, z, d["taps"], d["geom"].off_a),
             LB.lista3d_wgrad(z, y, d["taps"], d["geom"].off_s),
             LB.lista3d_wgrad(y, z, d["taps"], d["geom"].off_a, rows=rows),
             *LB.lista3d_syn_adjoint(y, ws_adj, z, d["geom"], base=z, alpha=-1.0))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_wrapper_rejects_non_contiguous(cuda):
    d = _setup((5, 5, 3), 2, 8, 1, 8, 16, 16)
    r = d["r"].to(cuda).transpose(3, 4)
    with pytest.raises(ValueError):
        L.lista3d_ana_threshold(r, None, d["wa"].to(cuda), d["tau"].to(cuda), d["geom"])


# --- big frames: the shapes of the TPU's banded and ring kernels (K9-K12)
# on the same kernels. P, s, M, N, D, H, W, C: a 427-wide code grid (the
# 854-wide native frame: ragged 64-column tiles), the (9,9,5) taps of the
# fastMRI config (5x5x3 phase taps) with an odd code depth of 15, and the
# flagship taps with an odd code height
BIG_SHAPES = [
    ((9, 9, 5), 2, 24, 1, 30, 40, 854, 1),
    ((7, 7, 5), 2, 40, 1, 16, 66, 854, 1),
]


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", BIG_SHAPES)
def test_bigframe_forward_kernels_match_plain(cuda, P, s, M, N, D, H, W, C):
    d = _setup(P, s, M, N, D, H, W, C)
    for z in (None, d["z"]):
        ref = L.lista3d_ana_threshold_plain(d["r"], z, d["wa"], d["tau"], d["geom"])
        got = L.lista3d_ana_threshold(
            d["r"].to(cuda), None if z is None else z.to(cuda), d["wa"].to(cuda),
            d["tau"].to(cuda), d["geom"])
        torch.cuda.synchronize()
        assert _rel(got, ref) <= 1e-5
    ref = L.lista3d_syn_residual_plain(d["z"], d["ws"], d["geom"], mask=d["mask"], y=d["y"])
    got = L.lista3d_syn_residual(d["z"].to(cuda), d["ws"].to(cuda), d["geom"],
                                 mask=d["mask"].to(cuda), y=d["y"].to(cuda))
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", BIG_SHAPES)
def test_bigframe_reverse_kernels_match_plain(cuda, P, s, M, N, D, H, W, C):
    """The weight gradient sums ~130,000 code positions of random-sign
    products per entry, in another order on each side: fp32 rounding
    grows like sqrt(n)·eps (~2e-5 of the largest entry), so it is held to
    1e-4; the adjoint, a sum of a few hundred terms per output, to 1e-5."""
    d = _setup(P, s, M, N, D, H, W, C)
    geom, taps = d["geom"], d["taps"]
    ref = LB.lista3d_syn_adjoint_plain(d["y"], d["ws_adj"], d["z"], geom, base=d["base"],
                                       alpha=-1.0)
    got = LB.lista3d_syn_adjoint(d["y"].to(cuda), d["ws_adj"].to(cuda), d["z"].to(cuda),
                                 geom, base=d["base"].to(cuda), alpha=-1.0)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-5
    for x, y in ((d["r"], d["z"]), (d["y"], d["z"])):  # dA, and dB as the loop runs it
        ref = LB.lista3d_wgrad_plain(x, y, taps, geom.off_a, alpha=-1.0)
        got = LB.lista3d_wgrad(x.to(cuda), y.to(cuda), taps, geom.off_a, alpha=-1.0)
        torch.cuda.synchronize()
        assert _rel(got, ref) <= 1e-4


def test_bigframe_grad_on_cuda_matches_cpu_and_counts_launches(cuda, monkeypatch):
    """K=3 forward and gradient through the kernels at a ragged big frame
    with the (9,9,5) taps, a mask and per-sample thresholds, against the
    CPU reverse loop. The banks have bench.py's 0.02 scale: at 0.1 the
    405-tap banks make the iteration expansive, and the CPU's own fp32 dA
    is 1.9e-4 off its fp64 value."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    rng = np.random.default_rng(6)
    K, M, P, s = 3, 13, (9, 9, 5), 2
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    yp, tgt = 0.3 * f(2, 1, 6, 34, 854), f(2, 1, 6, 34, 854)
    A, B = 0.02 * f(K, M, 1, *P), 0.02 * f(K, M, 1, *P)
    t = 0.02 * f(K, 2, M, 1, 1, 1).abs()
    c = torch.tensor([0.1, 0.2]).reshape(2, 1, 1, 1, 1)
    mask = (f(*yp.shape) > 0).float()

    def grads(dev):
        prm = [v.to(dev).requires_grad_() for v in (A, B, t)]
        x = lista3d_fused_diff(yp.to(dev), *prm, c.to(dev), stride=s, mask=mask.to(dev))
        loss = ((x - tgt.to(dev)) ** 2).mean()
        return [x.detach().cpu(), *(g.cpu() for g in torch.autograd.grad(loss, prm))]

    want = grads("cpu")
    L.launches.clear()
    got = grads(cuda)
    assert dict(L.launches) == {"lista3d_ana_threshold": K,
                                "lista3d_syn_residual": 2 * K - 1,
                                "lista3d_syn_adjoint": K, "lista3d_wgrad": 2 * K}
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4




def test_pipelined_stream_on_cuda_equals_the_staged_loop(cuda, monkeypatch):
    """denoise_long_video_pipelined's side-stream copies give the staged
    chunk loop's output bit for bit, with one and with three chunks in
    flight (seven chunks: every pinned slot is reused)."""
    from cdlnet_tpu_torch.models import CDLNetVideo, streaming

    model = CDLNetVideo(K=3, M=13, P=(5, 5, 3), s=2, adaptive=True, depth=8,
                        backend="pallas").to(cuda).init(torch.Generator().manual_seed(0))
    clip = np.random.default_rng(7).uniform(size=(1, 1, 32, 32, 48)).astype(np.float32)
    staged = streaming.denoise_long_video(model, torch.from_numpy(clip).to(cuda), 25.0,
                                          chunk_depth=8, overlap=2).cpu().numpy()
    for in_flight in (1, 3):
        monkeypatch.setattr(streaming, "MAX_IN_FLIGHT", in_flight)
        piped = streaming.denoise_long_video_pipelined(model, clip, 25.0, chunk_depth=8,
                                                       overlap=2)
        np.testing.assert_array_equal(piped, staged)

# --- the 2D forward pair (kernels/lista2d.py) ---

def _setup2d(P, s, M, N, H, W, C, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    pad = (P - 1) // 2
    geom = L.Geom(s, (P, P), (pad, pad))
    wa = L2.prep_A2m_2d(0.1 * f(1, M, C, P, P), s, (pad, pad))[0]
    ws = L2.prep_B2m_2d(0.1 * f(1, M, C, P, P), s, (pad, pad))[0]
    Cp, Hc, Wc = C * s * s, H // s, W // s
    z = f(N, M, Hc, Wc)
    z = torch.where(z.abs() < 0.5, torch.zeros_like(z), z)  # sparse codes
    mask = torch.from_numpy((rng.uniform(size=(N, Cp, Hc, Wc)) > 0.5).astype(np.float32))
    tau = torch.from_numpy(rng.uniform(0.0, 0.5, (N, M)).astype(np.float32))
    return dict(wa=wa, ws=ws, r=f(N, Cp, Hc, Wc), z=z, y=f(N, Cp, Hc, Wc), mask=mask,
                tau=tau, geom=geom)


SHAPES_2D = [
    # P, s, M, N, H, W, C — JDD's stride-1 colour form; the flagship form on
    # a 64x96 code grid; a ragged width (Wc=75) with two images (per-image
    # tau); stride 2 with colour (phase = channel % s^2)
    (7, 1, 48, 1, 40, 70, 3),
    (7, 2, 169, 1, 128, 192, 1),
    (7, 2, 13, 2, 32, 150, 1),
    (5, 2, 6, 2, 24, 20, 3),
    # where the launch splits the codes over blocks (analysis) or a cluster
    # (synthesis): the flagship 128^2 image, the CSR models' P=9 taps on a
    # 320x192 code grid, stride 2 with colour (Cp=12) at the flagship M
    (7, 2, 169, 1, 128, 128, 1),
    (9, 2, 169, 1, 640, 384, 1),
    (7, 2, 169, 1, 128, 128, 3),
]


@pytest.mark.parametrize("P,s,M,N,H,W,C", SHAPES_2D)
@pytest.mark.parametrize("first", [False, True])
def test_2d_ana_threshold_matches_plain(cuda, P, s, M, N, H, W, C, first):
    d = _setup2d(P, s, M, N, H, W, C)
    z = None if first else d["z"]
    ref = L2.lista2d_ana_threshold_plain(d["r"], z, d["wa"], d["tau"], d["geom"])
    got = L2.lista2d_ana_threshold(
        d["r"].to(cuda), None if z is None else z.to(cuda), d["wa"].to(cuda),
        d["tau"].to(cuda), d["geom"])
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("P,s,M,N,H,W,C", SHAPES_2D)
@pytest.mark.parametrize("residual", [False, True])
def test_2d_syn_residual_matches_plain(cuda, P, s, M, N, H, W, C, residual):
    d = _setup2d(P, s, M, N, H, W, C)
    mask, y = (d["mask"], d["y"]) if residual else (None, None)
    ref = L2.lista2d_syn_residual_plain(d["z"], d["ws"], d["geom"], mask=mask, y=y)
    got = L2.lista2d_syn_residual(
        d["z"].to(cuda), d["ws"].to(cuda), d["geom"],
        mask=None if mask is None else mask.to(cuda),
        y=None if y is None else y.to(cuda))
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5


def _off_grid(t, cuda):
    """t on the card, 4 bytes off the 16-byte grid (a history slice of an
    odd-sized code grid sits so)."""
    return torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("P,s,M,N,H,W,C", [SHAPES_2D[4], SHAPES_2D[2], SHAPES_2D[0]])
def test_2d_pair_on_operands_off_the_grid_matches_plain(cuda, P, s, M, N, H, W, C):
    """Every operand of both kernels 4 bytes off the 16-byte grid, the
    outputs written into history slices that sit so too, the analysis in
    place: the staging keeps each row's offset and the epilogues go
    scalar."""
    d = _setup2d(P, s, M, N, H, W, C)
    Cp, Hc, Wc = C * s * s, H // s, W // s
    ref_z = L2.lista2d_ana_threshold_plain(d["r"], d["z"], d["wa"], d["tau"], d["geom"])
    ref_r = L2.lista2d_syn_residual_plain(d["z"], d["ws"], d["geom"], mask=d["mask"], y=d["y"])
    z_hist = torch.full((2 * N * M * Hc * Wc + 1,), float("nan"), device=cuda)
    r_hist = torch.full((N * Cp * Hc * Wc + 1,), float("nan"), device=cuda)
    z_in = z_hist[1:1 + N * M * Hc * Wc].view(N, M, Hc, Wc).copy_(d["z"])
    r_out = r_hist[1:].view(N, Cp, Hc, Wc)
    wa, ws, r, tau, mask, y = (_off_grid(d[k], cuda) for k in ("wa", "ws", "r", "tau", "mask",
                                                               "y"))
    got_r = L2.lista2d_syn_residual(z_in, ws, d["geom"], mask=mask, y=y, out=r_out)
    torch.cuda.synchronize()
    assert got_r.data_ptr() == r_out.data_ptr() and got_r.data_ptr() % 16 == 4
    assert _rel(got_r, ref_r) <= 1e-5
    got_z = L2.lista2d_ana_threshold(r, z_in, wa, tau, d["geom"], out=z_in)
    torch.cuda.synchronize()
    assert got_z.data_ptr() == z_in.data_ptr()
    assert _rel(got_z, ref_z) <= 1e-5
    assert torch.isnan(z_hist[0]) and torch.isnan(r_hist[0])
    assert torch.isnan(z_hist[1 + N * M * Hc * Wc:]).all()


@pytest.mark.parametrize("P,s,M,N,H,W,C", [SHAPES_2D[4], SHAPES_2D[5]])
@pytest.mark.parametrize("off_grid", [False, True])
def test_2d_forward_kernels_are_deterministic(cuda, P, s, M, N, H, W, C, off_grid):
    """Two calls bitwise equal where the launch splits the codes: the
    cluster's partial sums meet in rank order, whether the synthesis stages
    its codes by tensor copies or (codes off the 16-byte grid) row by
    row."""
    d = _setup2d(P, s, M, N, H, W, C)
    r, wa, ws, tau, mask, y = (d[k].to(cuda) for k in ("r", "wa", "ws", "tau", "mask", "y"))
    z = _off_grid(d["z"], cuda) if off_grid else d["z"].to(cuda)
    runs = [(L2.lista2d_ana_threshold(r, z, wa, tau, d["geom"]),
             L2.lista2d_ana_threshold(r, None, wa, tau, d["geom"]),
             L2.lista2d_syn_residual(z, ws, d["geom"], mask=mask, y=y),
             L2.lista2d_syn_residual(z, ws, d["geom"]))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_2d_pair_fills_the_card_at_one_128_image(cuda):
    """At the flagship width on one 128^2 image (a 64x64 code grid) each
    kernel launches at least one block per SM; at ten such images the
    analysis keeps every code in a block and the synthesis splits its codes
    at most in two."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ana = L2.launch_grid(False, 1, 4, 169, 64, 64, 4, 4)
    syn = L2.launch_grid(True, 1, 169, 4, 64, 64, 4, 4)
    assert ana["blocks"] >= sms and syn["blocks"] >= sms
    assert ana["codes"] * ana["grid"][1] >= 169 and syn["split"] > 1
    assert L2.launch_grid(False, 10, 4, 169, 64, 64, 4, 4)["codes"] == 176
    train = L2.launch_grid(True, 10, 169, 4, 64, 64, 4, 4)
    assert train["split"] <= 4 and train["rows"] == 7


@pytest.mark.parametrize("C,s,use_mask", [(1, 2, False), (3, 1, True), (3, 2, True)])
def test_2d_fused_on_cuda_matches_cpu_and_counts_launches(cuda, C, s, use_mask):
    rng = np.random.default_rng(3)
    K, M, P = 3, 13, 7
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    yp = 0.3 * f(2, C, 24, 38)
    A, B = 0.1 * f(K, M, C, P, P), 0.1 * f(K, M, C, P, P)
    t = 0.02 * f(K, 2, M, 1, 1).abs()
    c = torch.tensor([0.1, 0.2]).reshape(2, 1, 1, 1)
    mask = (f(*yp.shape) > 0).float() if use_mask else None
    x_ref, z_ref = L2.lista2d_fused(yp, A, B, t, c, stride=s, mask=mask, return_z=True)
    L.launches.clear()
    x, z = L2.lista2d_fused(*(v.to(cuda) for v in (yp, A, B, t, c)), stride=s,
                            mask=None if mask is None else mask.to(cuda), return_z=True)
    torch.cuda.synchronize()
    assert dict(L.launches) == {"lista2d_ana_threshold": K, "lista2d_syn_residual": K}
    np.testing.assert_allclose(x.cpu().numpy(), x_ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(z.cpu().numpy(), z_ref.numpy(), atol=1e-4)


@pytest.mark.parametrize("bad", ["non_contiguous", "float64"])
def test_2d_wrappers_reject_what_the_kernel_does_not_take(cuda, bad):
    d = _setup2d(7, 2, 8, 1, 16, 16, 1)
    r, z = d["r"].to(cuda), d["z"].to(cuda)
    if bad == "non_contiguous":
        r, z = r.transpose(2, 3), z.transpose(2, 3)
    else:
        r, z = r.double(), z.double()
    with pytest.raises(ValueError):
        L2.lista2d_ana_threshold(r, None, d["wa"].to(cuda), d["tau"].to(cuda), d["geom"])
    with pytest.raises(ValueError):
        L2.lista2d_syn_residual(z, d["ws"].to(cuda), d["geom"])


# --- the 2D reverse kernels (kernels/lista2d_bwd.py) ---

def _setup2d_bwd(P, s, M, N, H, W, C, seed=0):
    d = _setup2d(P, s, M, N, H, W, C, seed)
    rng = np.random.default_rng(seed + 1)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    Hc, Wc = H // s, W // s
    d.update(ws_adj=LB.adjoint_bank(d["ws"], 2), wa_adj=LB.adjoint_bank(d["wa"], 2),
             g=f(N, C * s * s, Hc, Wc), base=f(N, M, Hc, Wc), taps=tuple(d["wa"].shape[1:3]))
    return d


SHAPES_2D_BWD = [
    # P, s, M, N, H, W, C — odd code grids (Hc=19, Wc=37), one and three
    # images, strides 1 and 2, grey and colour (stride 2 with colour is the
    # case a 3D phase map would get wrong), the flagship width
    (7, 2, 13, 3, 38, 74, 1),
    (7, 1, 20, 1, 19, 37, 3),
    (5, 2, 6, 3, 38, 22, 3),
    (7, 2, 169, 1, 128, 128, 1),
]


# the 2D reverse kernels' further shapes: a 427-wide code grid, one phase
# channel (stride 1, grey), the CSR models' P=9 taps, and the flagship
# train shape's full width and long reduction (M = 169, 10 crops of 128^2:
# 40,960 positions a weight-gradient entry)
REVERSE_SHAPES_2D = [
    (7, 2, 24, 1, 20, 854, 1),
    (7, 1, 12, 2, 20, 44, 1),
    (9, 2, 169, 1, 64, 96, 1),
    (7, 2, 169, 10, 128, 128, 1),
]


@pytest.mark.parametrize("P,s,M,N,H,W,C", SHAPES_2D_BWD + REVERSE_SHAPES_2D)
@pytest.mark.parametrize("with_base,alpha", [(False, 1.0), (True, -1.0)])
def test_2d_syn_adjoint_matches_plain(cuda, P, s, M, N, H, W, C, with_base, alpha):
    d = _setup2d_bwd(P, s, M, N, H, W, C)
    base = d["base"] if with_base else None
    ref = LB2.lista2d_syn_adjoint_plain(d["g"], d["ws_adj"], d["z"], d["geom"],
                                        base=base, alpha=alpha)
    got = LB2.lista2d_syn_adjoint(
        d["g"].to(cuda), d["ws_adj"].to(cuda), d["z"].to(cuda), d["geom"],
        base=None if base is None else base.to(cuda), alpha=alpha)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel(g, r) <= 1e-5


@pytest.mark.parametrize("P,s,M,N,H,W,C", SHAPES_2D_BWD + REVERSE_SHAPES_2D)
@pytest.mark.parametrize("form", ["dA", "dB-swapped"])
def test_2d_wgrad_matches_plain(cuda, P, s, M, N, H, W, C, form):
    d = _setup2d_bwd(P, s, M, N, H, W, C)
    x, y = (d["r"], d["z"]) if form == "dA" else (d["g"], d["z"])
    ref = LB2.lista2d_wgrad_plain(x, y, d["taps"], d["geom"].off_a, alpha=-1.0)
    got = LB2.lista2d_wgrad(x.to(cuda), y.to(cuda), d["taps"], d["geom"].off_a, alpha=-1.0)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("P,s,M,N,H,W,C", SHAPES_2D_BWD[:3])
def test_2d_analysis_adjoint_matches_plain(cuda, P, s, M, N, H, W, C):
    d = _setup2d_bwd(P, s, M, N, H, W, C)
    ref = L2.lista2d_syn_residual_plain(d["z"], d["wa_adj"], d["geom"], mask=d["mask"])
    got = L2.lista2d_syn_residual(d["z"].to(cuda), d["wa_adj"].to(cuda), d["geom"],
                                  mask=d["mask"].to(cuda))
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("P,s,M,N,H,W,C", SHAPES_2D_BWD[:3] + REVERSE_SHAPES_2D)
@pytest.mark.parametrize("form", ["dA", "dB-swapped"])
def test_2d_wgrad_on_the_phase_rows_matches_plain(cuda, P, s, M, N, H, W, C, form):
    """The form the reverse loop runs: only the phase rows the prep keeps
    (49 of 64 at the flagship taps), zeros on the others."""
    d = _setup2d_bwd(P, s, M, N, H, W, C)
    geom = d["geom"]
    rows = LB.phase_rows(geom, d["wa"].shape[0], 2)
    x = d["r"] if form == "dA" else d["g"]
    ref = LB2.lista2d_wgrad_plain(x, d["z"], d["taps"], geom.off_a, alpha=-1.0, rows=rows)
    got = LB2.lista2d_wgrad(x.to(cuda), d["z"].to(cuda), d["taps"], geom.off_a, alpha=-1.0,
                            rows=rows)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5
    assert not got.cpu()[~rows].any()


@pytest.mark.parametrize("P,s,M,N,H,W,C", [SHAPES_2D_BWD[0], REVERSE_SHAPES_2D[0],
                                          SHAPES_2D_BWD[1]])
def test_2d_reverse_kernels_on_operands_off_the_grid_match_plain(cuda, P, s, M, N, H, W, C):
    """Every operand 4 bytes off the 16-byte grid (history slices)."""
    d = _setup2d_bwd(P, s, M, N, H, W, C)
    geom, taps = d["geom"], d["taps"]
    g, z, r, base, ws_adj = (_off_grid(d[k], cuda) for k in ("g", "z", "r", "base", "ws_adj"))
    ref = LB2.lista2d_syn_adjoint_plain(d["g"], d["ws_adj"], d["z"], geom, base=d["base"],
                                        alpha=-1.0)
    got = LB2.lista2d_syn_adjoint(g, ws_adj, z, geom, base=base, alpha=-1.0)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert _rel(a, b) <= 1e-5
    rows = LB.phase_rows(geom, d["wa"].shape[0], 2)
    for x, xc in ((d["r"], r), (d["g"], g)):
        for kw in ({}, {"rows": rows}):
            ref = LB2.lista2d_wgrad_plain(x, d["z"], taps, geom.off_a, alpha=-1.0, **kw)
            got = LB2.lista2d_wgrad(xc, z, taps, geom.off_a, alpha=-1.0, **kw)
            torch.cuda.synchronize()
            assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("off_grid", [False, True])
def test_2d_reverse_kernels_are_deterministic(cuda, off_grid):
    d = _setup2d_bwd(7, 2, 169, 10, 128, 128, 1)
    put = (lambda t: _off_grid(t, cuda)) if off_grid else (lambda t: t.to(cuda))
    z, r, g, base = (put(d[k]) for k in ("z", "r", "g", "base"))
    ws_adj, taps, off = d["ws_adj"].to(cuda), d["taps"], d["geom"].off_a
    rows = LB.phase_rows(d["geom"], d["wa"].shape[0], 2)
    runs = [(LB2.lista2d_wgrad(r, z, taps, off), LB2.lista2d_wgrad(g, z, taps, off),
             LB2.lista2d_wgrad(g, z, taps, off, rows=rows),
             *LB2.lista2d_syn_adjoint(g, ws_adj, z, d["geom"], base=base, alpha=-1.0))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _first_adam_step_bound(g1, g2, p, lr, eps):
    """Entrywise bound on the difference of two first steps of Adam (zero
    moments, eps_root 0) from the same parameters p, taken with gradients
    g1 and g2: a step moves an entry by lr * g / (|g| + eps), and
    |f(a) - f(b)| <= 2 |a - b| / (max(|a|, |b|) + eps) for f(g) = g / (|g| +
    eps). Where |g| >> eps that is ~2 lr times the gradients' relative
    difference; where |g| is near eps, up to 2 lr. The slack covers fp32
    rounding of the step and of project()."""
    amp = 2.0 * (g1 - g2).abs() / (torch.maximum(g1.abs(), g2.abs()) + eps)
    return lr * amp.clamp(max=2.0) + 1e-6 * (p.abs() + lr)


def _clipped(grads, clip):
    """The gradients as ClippedAdam clips them (global l2 norm)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    return grads if norm < clip else [g * (clip / norm) for g in grads]


@pytest.mark.parametrize("C,s,use_mask", [(1, 2, False), (3, 1, True), (3, 2, True)])
def test_2d_train_step_on_cuda_matches_cpu_and_counts_launches(cuda, C, s, use_mask,
                                                                record_property, monkeypatch):
    """One 2D training step (noise drawn once on the CPU) on the card
    against the CPU's: the loss, dA, dB and dt (1e-4, the JAX package's gate
    for its reverse kernels) with 2K + K + (K-1) + 2K launches under the 2D
    names, and the parameters after train_update's clipped Adam and
    project(), held to _first_adam_step_bound: per entry for t (project()
    clamps it), per (k, m, c) filter in l2 for A and B (project() scales
    each filter onto the unit ball, a 1-Lipschitz map in that norm).

    The bound, not a relative tolerance on the parameters: Adam's first
    step is ~lr * sign(g), so on entries whose gradient is near eps it turns
    fp32 noise in g into an update difference of up to 2 lr. The recorded
    properties (pytest --junitxml) show where the largest difference lies."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    from cdlnet_tpu_torch.data.noise import awgn, gen_bayer_mask
    from cdlnet_tpu_torch.models import CDLNet
    from cdlnet_tpu_torch.train.fit import train_update
    from cdlnet_tpu_torch.train.optim import make_optimizer

    K, lr, clip, eps = 3, 1e-3, 0.05, 1e-8
    clean = torch.from_numpy(np.random.default_rng(6).uniform(
        size=(3, C, 26, 34)).astype(np.float32))
    noisy, sigma = awgn(clean, (20, 30), torch.Generator().manual_seed(0))
    mask = gen_bayer_mask(clean) if use_mask else None
    obs = noisy if mask is None else mask * noisy
    out = {}
    for dev in ("cpu", "cuda"):
        model = CDLNet(K=K, M=13, P=7, s=s, C=C, adaptive=True, backend="pallas").init(
            torch.Generator().manual_seed(0)).to(dev)
        with torch.no_grad():
            model.t.fill_(0.01)
        batch = [x.to(dev) for x in (obs, sigma, clean)]
        m = None if mask is None else mask.to(dev)
        L.launches.clear()
        xhat, _ = model(batch[0], batch[1], mask=m)
        loss = ((xhat - batch[2]) ** 2).mean()
        grads = torch.autograd.grad(loss, (model.A, model.B, model.t))
        launches = dict(L.launches)
        opt = make_optimizer(lr, clip_grad=clip)
        state = opt.init(dict(model.named_parameters()))
        train_update(model, opt, state, *batch, mask=m)
        out[dev] = dict(loss=float(loss.detach()), launches=launches,
                        grads=[g.cpu() for g in grads],
                        params=[p.detach().cpu() for p in (model.A, model.B, model.t)])
    cpu, gpu = out["cpu"], out["cuda"]
    assert gpu["launches"] == {"lista2d_ana_threshold": K, "lista2d_syn_residual": 2 * K - 1,
                               "lista2d_syn_adjoint": K, "lista2d_wgrad": 2 * K}
    assert abs(gpu["loss"] - cpu["loss"]) <= 1e-5 * abs(cpu["loss"])
    for name, a, b in zip("ABt", gpu["grads"], cpu["grads"]):
        assert _rel(a, b) <= 1e-4, name
    for name, g1, g2, p1, p2 in zip("ABt", _clipped(gpu["grads"], clip),
                                    _clipped(cpu["grads"], clip), gpu["params"],
                                    cpu["params"]):
        bound = _first_adam_step_bound(g1, g2, p2, lr, eps)
        diff = (p1 - p2).abs()
        if name == "t":
            ratio = float((diff / bound).max())
        else:  # per filter over (kH, kW)
            ratio = float((diff.square().sum((3, 4)).sqrt()
                           / bound.square().sum((3, 4)).sqrt()).max())
        worst = int(diff.argmax())
        record_property(f"{name}_rel_diff", float(diff.max() / p2.abs().max()))
        record_property(f"{name}_max_diff_over_lr", float(diff.max()) / lr)
        record_property(f"{name}_worst_entry_abs_g_over_eps",
                        float(torch.maximum(g1.abs(), g2.abs()).flatten()[worst]) / eps)
        record_property(f"{name}_max_diff_over_bound", ratio)
        assert ratio <= 1.0, name


def test_2d_reverse_wrappers_reject_what_the_kernel_does_not_take(cuda):
    d = _setup2d_bwd(7, 2, 8, 1, 16, 16, 1)
    g = d["g"].to(cuda).transpose(2, 3)
    with pytest.raises(ValueError):
        LB2.lista2d_syn_adjoint(g, d["ws_adj"].to(cuda), d["z"].to(cuda), d["geom"])
    with pytest.raises(ValueError):
        LB2.lista2d_wgrad(d["r"].to(cuda).double(), d["z"].to(cuda), d["taps"],
                          d["geom"].off_a)


# --- the CSR analysis epilogues (kernels/lista2d.py: lista2d_ana_csr/_csrf2) ---

SHAPES_CSR = [
    # P, s, M, N, H, W — the CSR models' width (argscsr.json: M=169, P=9,
    # s=2) at 2 x 128^2 (per-image tau and gamma) and at one native fastMRI
    # frame, raw (640x368: a code grid 184 wide, a ragged 56-column tile)
    # and bucketed (640x384)
    (9, 2, 169, 2, 128, 128),
    (9, 2, 169, 1, 640, 368),
    (9, 2, 169, 1, 640, 384),
]


@pytest.mark.parametrize("P,s,M,N,H,W", SHAPES_CSR)
@pytest.mark.parametrize("mode", ["csr", "csr k=0", "csrf2", "csrf2 k=0"])
def test_2d_csr_analysis_matches_plain(cuda, P, s, M, N, H, W, mode):
    """Each CSR epilogue against its plain version on the card. The
    one-sided prox is continuous: max|d| / max|ref| <= 1e-5, as the ST
    analysis. The two-sided one jumps where its argument v crosses Ca, and
    the kernel's v differs from the plain version's by fp32 reassociation:
    there the gate is 1e-4 over the codes with |v - Ca| > 1e-5 max|v|, and
    the codes left out are fewer than 1e-3 of all."""
    d = _setup2d(P, s, M, N, H, W, 1)
    rng = np.random.default_rng(5)
    zp = d["z"]
    za = torch.from_numpy(rng.standard_normal(zp.shape).astype(np.float32))
    za = torch.where(za.abs() < 0.5, torch.zeros_like(za), za)
    gam1, gam2 = (torch.from_numpy(rng.uniform(0.0, 0.3, (N, M)).astype(np.float32))
                  for _ in range(2))
    r, z = (-d["y"], None) if mode.endswith("k=0") else (d["r"], 0.5 * d["z"])
    if mode.startswith("csrf2"):
        name, args = "lista2d_ana_csrf2", (r, z, d["wa"], d["tau"], gam1, gam2, zp, za)
    else:
        name, args = "lista2d_ana_csr", (r, z, d["wa"], d["tau"], gam1, zp)
    args = tuple(None if a is None else a.to(cuda) for a in args)
    L.launches.clear()
    got = getattr(L2, name)(*args, d["geom"])
    ref = getattr(L2, name + "_plain")(*args, d["geom"])
    torch.cuda.synchronize()
    assert dict(L.launches) == {name: 1} and got.shape == ref.shape
    if name == "lista2d_ana_csr":
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
        return
    v = L2.ana_argument_plain(*args[:3], d["geom"])
    keep = L2.csrf2_jump_gap(v, zp.to(cuda), za.to(cuda), args[3], gam2.to(cuda)) \
        > 1e-5 * v.abs().max()
    assert float((~keep).float().mean()) < 1e-3
    assert float(((got - ref).abs() * keep).max() / ref.abs().max()) <= 1e-4


def _csr_operands(P, s, M, N, H, W, seed=0):
    """_setup2d's operands at C = 1 (Cp = s^2), with the previous frame's
    code zp = z, a sparse following code za and gamma banks per (n, m)."""
    d = _setup2d(P, s, M, N, H, W, 1, seed)
    rng = np.random.default_rng(seed + 7)
    za = torch.from_numpy(rng.standard_normal(d["z"].shape).astype(np.float32))
    za = torch.where(za.abs() < 0.5, torch.zeros_like(za), za)
    gam1, gam2 = (torch.from_numpy(rng.uniform(0.0, 0.3, (N, M)).astype(np.float32))
                  for _ in range(2))
    return d, d["z"], za, gam1, gam2


def _csr_close(name, got, ref, args, geom):
    """got against ref as test_2d_csr_analysis_matches_plain holds them: the
    one-sided prox at 1e-5, the two-sided one at 1e-4 over the codes away
    from its jump (fewer than 1e-3 of them left out)."""
    if name == "lista2d_ana_csr":
        assert _rel(got, ref.cpu()) <= 1e-5
        return
    v = L2.ana_argument_plain(*args[:3], geom)
    keep = L2.csrf2_jump_gap(v, args[6], args[7], args[3], args[5]) > 1e-5 * v.abs().max()
    assert float((~keep).float().mean()) < 1e-3
    assert float(((got - ref).abs() * keep).max() / ref.abs().max()) <= 1e-4


@pytest.mark.parametrize("P,s,M,N,H,W", SHAPES_CSR)
@pytest.mark.parametrize("name", ["lista2d_ana_csr", "lista2d_ana_csrf2"])
@pytest.mark.parametrize("first", [False, True])
def test_2d_csr_analysis_with_zero_neighbours_and_gammas_is_the_st_analysis(
        cuda, P, s, M, N, H, W, name, first):
    """prox_csr(v, 0; tau, 0) and prox_csr_f2(v, 0, 0; tau, 0, 0) are
    soft(v, tau), and the CSR analyses run the ST analysis's mainloop: with
    zero neighbour codes and gamma banks their codes equal
    lista2d_ana_threshold's bit for bit."""
    d = _setup2d(P, s, M, N, H, W, 1)
    r, wa, tau = (d[k].to(cuda) for k in ("r", "wa", "tau"))
    z = None if first else d["z"].to(cuda)
    codes, bank = torch.zeros_like(d["z"], device=cuda), torch.zeros_like(tau)
    prox = (bank, codes) if name == "lista2d_ana_csr" else (bank, bank, codes, codes)
    st = L2.lista2d_ana_threshold(r, z, wa, tau, d["geom"])
    got = getattr(L2, name)(r, z, wa, tau, *prox, d["geom"])
    torch.cuda.synchronize()
    assert int((st != 0).sum()) > 0
    assert torch.equal(got, st)


@pytest.mark.parametrize("P,s,M,N,H,W", [SHAPES_CSR[0], SHAPES_CSR[1]])
@pytest.mark.parametrize("name", ["lista2d_ana_csr", "lista2d_ana_csrf2"])
@pytest.mark.parametrize("off_grid", [False, True])
def test_2d_csr_analyses_are_deterministic(cuda, P, s, M, N, H, W, name, off_grid):
    """Two calls bitwise equal, codes and u history, on aligned operands (the
    16-byte epilogue) and off the grid (the scalar one)."""
    d, zp, za, gam1, gam2 = _csr_operands(P, s, M, N, H, W)
    put = (lambda t: _off_grid(t, cuda)) if off_grid else (lambda t: t.to(cuda))
    r, wa, tau, g1, g2, z, zp, za = (put(t) for t in (d["r"], d["wa"], d["tau"], gam1, gam2,
                                                      0.5 * d["z"], zp, za))
    args = (r, z, wa, tau, g1, zp) if name == "lista2d_ana_csr" else \
        (r, z, wa, tau, g1, g2, zp, za)
    runs = []
    for _ in range(2):
        u = put(torch.zeros_like(d["z"]))
        runs.append((getattr(L2, name)(*args, d["geom"], u_out=u), u))
    torch.cuda.synchronize()
    assert (runs[0][1].data_ptr() % 16 == 4) == off_grid
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P,s,M,N,H,W", SHAPES_CSR[:2])
@pytest.mark.parametrize("name", ["lista2d_ana_csr", "lista2d_ana_csrf2"])
def test_2d_csr_analysis_on_operands_off_the_grid_matches_plain(cuda, P, s, M, N, H, W, name):
    """z_old, zp and u_out history slices 4 bytes off the 16-byte grid (za
    and the banks too), the codes written in place over z_old: the
    epilogue goes scalar, and codes and u history match the plain
    version's."""
    d, zp, za, gam1, gam2 = _csr_operands(P, s, M, N, H, W)
    n = d["z"].numel()
    hist = torch.full((3 * n + 1,), float("nan"), device=cuda)  # z, zp, u slices
    z_in, zp_in, u_out = (hist[1 + i * n:1 + (i + 1) * n].view(d["z"].shape) for i in range(3))
    z_in.copy_(0.5 * d["z"])
    zp_in.copy_(zp)
    r, wa, tau, g1, g2, za = (_off_grid(t, cuda) for t in (d["r"], d["wa"], d["tau"], gam1,
                                                           gam2, za))
    args = (r, z_in, wa, tau, g1, zp_in) if name == "lista2d_ana_csr" else \
        (r, z_in, wa, tau, g1, g2, zp_in, za)
    ref_args = tuple(a.clone() for a in args)
    ref = getattr(L2, name + "_plain")(*ref_args, d["geom"])
    v = L2.ana_argument_plain(*ref_args[:3], d["geom"])
    got = getattr(L2, name)(*args, d["geom"], out=z_in, u_out=u_out)
    torch.cuda.synchronize()
    assert got.data_ptr() == z_in.data_ptr() and got.data_ptr() % 16 == 4
    assert u_out.data_ptr() % 16 == 4 and zp_in.data_ptr() % 16 == 4
    _csr_close(name, got, ref, ref_args, d["geom"])
    assert float((u_out - v).abs().max() / v.abs().max()) <= 1e-5
    assert torch.isnan(hist[0])


@pytest.mark.parametrize("P,s,M,N,H,W", [
    # several images with their own tau and gamma, at Cp = 1 (s = 1: one
    # phase a stage of 4 channels, three quarters padding) and Cp = 4, on
    # code grids with ragged widths
    (9, 1, 169, 3, 40, 72),
    (9, 2, 169, 3, 96, 150),
])
@pytest.mark.parametrize("name", ["lista2d_ana_csr", "lista2d_ana_csrf2"])
@pytest.mark.parametrize("first", [False, True])
def test_2d_csr_analysis_with_per_image_gammas_matches_plain(cuda, P, s, M, N, H, W, name,
                                                             first):
    d, zp, za, gam1, gam2 = _csr_operands(P, s, M, N, H, W, seed=3)
    z = None if first else 0.5 * d["z"]
    args = (d["r"], z, d["wa"], d["tau"], gam1, zp) if name == "lista2d_ana_csr" else \
        (d["r"], z, d["wa"], d["tau"], gam1, gam2, zp, za)
    args = tuple(None if a is None else a.to(cuda) for a in args)
    got = getattr(L2, name)(*args, d["geom"])
    ref = getattr(L2, name + "_plain")(*args, d["geom"])
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    _csr_close(name, got, ref, args, d["geom"])


@pytest.mark.parametrize("names", [("z_prev", "g"), ("z_after", "g2"),
                                   ("z_prev", "z_after", "g", "g2")])
def test_2d_fused_csr_on_cuda_matches_cpu_and_counts_launches(cuda, names):
    """lista2d_fused's CSR modes on the card: K launches of the mode's
    analysis and K of the synthesis, codes and output as on the CPU."""
    rng = np.random.default_rng(4)
    K, M, P, N = 3, 13, 7, 2
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    yp = 0.3 * f(N, 1, 24, 38)
    A, B = 0.1 * f(K, M, 1, P, P), 0.1 * f(K, M, 1, P, P)
    t = 0.02 * f(K, 2, M, 1, 1).abs()
    c = torch.tensor([0.1, 0.2]).reshape(2, 1, 1, 1)
    kw = {name: (f(N, M, 12, 19) if name.startswith("z") else 0.5 * f(K, 2, M, 1, 1).abs())
          for name in names}
    x_ref, z_ref = L2.lista2d_fused(yp, A, B, t, c, stride=2, return_z=True, **kw)
    L.launches.clear()
    x, z = L2.lista2d_fused(*(v.to(cuda) for v in (yp, A, B, t, c)), stride=2,
                            return_z=True, **{k: v.to(cuda) for k, v in kw.items()})
    torch.cuda.synchronize()
    ana = "lista2d_ana_csrf2" if len(names) == 4 else "lista2d_ana_csr"
    assert dict(L.launches) == {ana: K, "lista2d_syn_residual": K}
    np.testing.assert_allclose(x.cpu().numpy(), x_ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(z.cpu().numpy(), z_ref.numpy(), atol=1e-4)


def test_2d_csr_wrappers_reject_what_the_kernel_does_not_take(cuda):
    d = _setup2d(7, 2, 8, 1, 16, 16, 1)
    r, wa, tau = (d[k].to(cuda) for k in ("r", "wa", "tau"))
    zp = d["z"].to(cuda)
    with pytest.raises(ValueError, match="zp"):
        L2.lista2d_ana_csr(r, None, wa, tau, tau, zp.double(), d["geom"])
    with pytest.raises(ValueError, match="gam2"):
        L2.lista2d_ana_csrf2(r, None, wa, tau, tau, tau[:, :4], zp, zp, d["geom"])


# --- the CSR adjoint epilogues (kernels/lista2d_bwd.py:
# lista2d_syn_adjoint_csr/_csrf2) and the u history of the CSR analyses ---

def _setup_csr_adjoint(P, s, M, N, H, W, mode, seed=0):
    """The adjoint's operands: g, B's unflipped bank and a base as for
    lista2d_syn_adjoint; a prox argument u, sparse neighbour codes (z_after
    equal to z_prev on a quarter of the codes, where sign(zp - za) = 0),
    tau and gamma banks, and z = the prox of u."""
    d = _setup2d_bwd(P, s, M, N, H, W, 1, seed)
    rng = np.random.default_rng(seed + 2)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    sparse = lambda t: torch.where(t.abs() < 0.5, torch.zeros_like(t), t)
    shape = d["z"].shape
    u, zp = f(*shape), sparse(f(*shape))
    za = torch.where(torch.from_numpy(rng.uniform(size=shape) < 0.25), zp, sparse(f(*shape)))
    gam1, gam2 = (torch.from_numpy(rng.uniform(0.0, 0.3, (N, M)).astype(np.float32))
                  for _ in range(2))
    bank = lambda b: b[:, :, None, None]
    if mode == "csrf2":
        z = prox_csr_f2(u, zp, za, bank(d["tau"]), bank(gam1), bank(gam2))
        ops = (u, d["tau"], gam1, gam2, zp, za)
    else:  # "csr", and "z_after alone": the one-sided kernel on (za, gam2)
        code, gam = (zp, gam1) if mode == "csr" else (za, gam2)
        z = prox_csr(u, code, bank(d["tau"]), bank(gam))
        ops = (u, d["tau"], gam, code)
    return d, z, ops


@pytest.mark.parametrize("P,s,M,N,H,W", SHAPES_CSR)
@pytest.mark.parametrize("mode", ["csr", "z_after alone", "csrf2"])
@pytest.mark.parametrize("with_base,alpha", [(False, 1.0), (True, -1.0)])
def test_2d_csr_adjoint_matches_plain(cuda, P, s, M, N, H, W, mode, with_base, alpha):
    """Each CSR adjoint epilogue against its plain version on the card: dv,
    dtau, the gamma banks' gradients and the neighbour codes' cotangents
    (added into buffers that already hold a value) within 1e-4 of max|ref|.
    The masks come from the same stored u in both, so the two-sided prox's
    jump does not enter."""
    d, z, ops = _setup_csr_adjoint(P, s, M, N, H, W, mode)
    f2 = mode == "csrf2"
    name = "lista2d_syn_adjoint_csrf2" if f2 else "lista2d_syn_adjoint_csr"
    start = [0.5 * c for c in ops[-(2 if f2 else 1):]]  # cotangent buffers' contents
    base = d["base"] if with_base else None
    args = (d["g"], d["ws_adj"], z, *ops)
    dref = [b.clone() for b in start]
    ref = getattr(LB2, name + "_plain")(*args, *dref, d["geom"], base=base, alpha=alpha)
    dgot = [b.to(cuda) for b in start]
    L.launches.clear()
    got = getattr(LB2, name)(*(a.to(cuda) for a in args), *dgot, d["geom"],
                             base=None if base is None else base.to(cuda), alpha=alpha)
    torch.cuda.synchronize()
    assert dict(L.launches) == {name: 1}
    for i, (a, b) in enumerate(zip((*got, *dgot), (*ref, *dref))):
        assert a.shape == b.shape
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-4, i


def _csr_adjoint_call(cuda, name, d, z, ops, put, base):
    """One CSR adjoint call on the card with every code tensor (z, u, the
    neighbour codes, their cotangent buffers, base) placed by `put`; the
    buffers start at half the codes. Returns (outputs, buffers)."""
    codes = ops[-(2 if name.endswith("f2") else 1):]
    bufs = [put(0.5 * c) for c in codes]
    args = (d["g"].to(cuda), d["ws_adj"].to(cuda), put(z), put(ops[0]),
            *(t.to(cuda) for t in ops[1:-len(codes)]), *(put(c) for c in codes))
    got = getattr(LB2, name)(*args, *bufs, d["geom"], base=None if base is None else put(base),
                             alpha=-1.0)
    return got, bufs


@pytest.mark.parametrize("P,s,M,N,H,W", SHAPES_CSR)
@pytest.mark.parametrize("mode", ["csr", "csrf2"])
@pytest.mark.parametrize("off_grid", [False, True])
def test_2d_csr_adjoints_are_deterministic(cuda, P, s, M, N, H, W, mode, off_grid):
    """Two calls bitwise equal, every output and the cotangent buffers, with
    the code tensors (history slices) on the 16-byte grid (the 16-byte
    epilogue) and off it (the scalar one)."""
    d, z, ops = _setup_csr_adjoint(P, s, M, N, H, W, mode)
    name = "lista2d_syn_adjoint_csrf2" if mode == "csrf2" else "lista2d_syn_adjoint_csr"
    put = (lambda t: _off_grid(t, cuda)) if off_grid else (lambda t: t.to(cuda))
    runs = [_csr_adjoint_call(cuda, name, d, z, ops, put, d["base"]) for _ in range(2)]
    torch.cuda.synchronize()
    assert (runs[0][1][0].data_ptr() % 16 == 4) == off_grid
    for a, b in zip([*runs[0][0], *runs[0][1]], [*runs[1][0], *runs[1][1]]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P,s,M,N,H,W", SHAPES_CSR)
@pytest.mark.parametrize("mode", ["csr", "csrf2"])
def test_2d_csr_adjoint_on_operands_off_the_grid_matches_plain(cuda, P, s, M, N, H, W, mode):
    """u, z, base, the neighbour codes and their cotangent buffers as
    history slices 4 bytes off the 16-byte grid: the epilogue goes scalar,
    and every output is the plain version's within 1e-4 of max|ref|."""
    d, z, ops = _setup_csr_adjoint(P, s, M, N, H, W, mode)
    name = "lista2d_syn_adjoint_csrf2" if mode == "csrf2" else "lista2d_syn_adjoint_csr"
    codes = ops[-(2 if mode == "csrf2" else 1):]
    dref = [0.5 * c for c in codes]
    ref = getattr(LB2, name + "_plain")(d["g"], d["ws_adj"], z, *ops, *dref, d["geom"],
                                        base=d["base"], alpha=-1.0)
    got, bufs = _csr_adjoint_call(cuda, name, d, z, ops, lambda t: _off_grid(t, cuda),
                                   d["base"])
    torch.cuda.synchronize()
    assert all(b.data_ptr() % 16 == 4 for b in bufs)
    for i, (a, b) in enumerate(zip((*got, *bufs), (*ref, *dref))):
        assert a.shape == b.shape
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-4, i


@pytest.mark.parametrize("P,s,M,N,H,W", SHAPES_CSR)
@pytest.mark.parametrize("mode", ["csr", "csrf2"])
@pytest.mark.parametrize("with_base", [False, True])
def test_2d_csr_adjoint_with_zero_neighbours_and_gammas_is_the_st_adjoint(
        cuda, P, s, M, N, H, W, mode, with_base):
    """With zero neighbour codes and gamma banks the prox is soft(u, tau)
    and its adjoint the soft threshold's subgradient; the CSR adjoints run
    the ST adjoint's mainloop and sum the dtau terms in its order, so their
    dv and dtau equal lista2d_syn_adjoint's bit for bit."""
    d, _, ops = _setup_csr_adjoint(P, s, M, N, H, W, mode)
    u, tau = ops[0], ops[1]
    z = ST(u, tau[:, :, None, None])
    nb = 2 if mode == "csrf2" else 1
    zero_ops = (u, tau, *[torch.zeros_like(tau)] * nb, *[torch.zeros_like(u)] * nb)
    name = "lista2d_syn_adjoint_csrf2" if mode == "csrf2" else "lista2d_syn_adjoint_csr"
    base = d["base"] if with_base else None
    got, _ = _csr_adjoint_call(cuda, name, d, z, zero_ops, lambda t: t.to(cuda), base)
    dv, dtau = LB2.lista2d_syn_adjoint(d["g"].to(cuda), d["ws_adj"].to(cuda), z.to(cuda),
                                       d["geom"], base=None if base is None else base.to(cuda),
                                       alpha=-1.0)
    torch.cuda.synchronize()
    assert int((dv != 0).sum()) > 0
    assert torch.equal(got[0], dv)
    assert torch.equal(got[1], dtau)


@pytest.mark.parametrize("P,s,M,N,H,W", SHAPES_CSR)
@pytest.mark.parametrize("two_sided", [False, True])
def test_2d_csr_analysis_writes_the_u_history(cuda, P, s, M, N, H, W, two_sided):
    """With u_out the CSR analyses store the prox argument z - A_k r (the
    plain version's within 1e-5) and write the same codes as without it."""
    d = _setup2d(P, s, M, N, H, W, 1)
    rng = np.random.default_rng(6)
    zp = d["z"]
    za = torch.from_numpy(rng.standard_normal(zp.shape).astype(np.float32))
    gam1, gam2 = (torch.from_numpy(rng.uniform(0.0, 0.3, (N, M)).astype(np.float32))
                  for _ in range(2))
    if two_sided:
        name, args = "lista2d_ana_csrf2", (d["r"], 0.5 * zp, d["wa"], d["tau"], gam1, gam2, zp, za)
    else:
        name, args = "lista2d_ana_csr", (d["r"], 0.5 * zp, d["wa"], d["tau"], gam1, zp)
    args = tuple(a.to(cuda) for a in args)
    u = torch.empty_like(args[1])
    z_u = getattr(L2, name)(*args, d["geom"], u_out=u)
    z = getattr(L2, name)(*args, d["geom"])
    v = L2.ana_argument_plain(*args[:3], d["geom"])
    torch.cuda.synchronize()
    assert torch.equal(z_u, z)
    assert float((u - v).abs().max() / v.abs().max()) <= 1e-5


@pytest.mark.parametrize("names", [(), ("z_prev", "g"), ("z_after", "g2"),
                                   ("z_prev", "z_after", "g", "g2")])
def test_2d_csr_train_on_cuda_matches_cpu_and_counts_launches(cuda, names, monkeypatch):
    """csr_fused_2d_train on the card: x, z and every gradient (A, B, t, the
    gamma banks, the neighbour codes; the returned code's cotangent seeding
    the reverse) as on the CPU, with the designed launches: K of the mode's
    analysis and 2K - 1 syntheses forward, K of its adjoint, K - 1
    syntheses (the analysis adjoint) and 2K wgrads in reverse (fp32
    histories: the kernels' fp32 gradients)."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")
    rng = np.random.default_rng(8)
    K, M, P, N = 3, 13, 7, 2
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    yp = 0.3 * f(N, 1, 24, 38)
    leaves = dict(A=0.1 * f(K, M, 1, P, P), B=0.1 * f(K, M, 1, P, P),
                  t=0.02 * f(K, 2, M, 1, 1).abs())
    leaves.update({n: (f(N, M, 12, 19) if n.startswith("z") else 0.5 * f(K, 2, M, 1, 1).abs())
                   for n in names})
    c = torch.tensor([0.1, 0.2]).reshape(2, 1, 1, 1)
    cot = (f(N, 1, 24, 38), f(N, M, 12, 19))
    outs = {}
    for dev in ("cpu", cuda):
        lv = {n: v.to(dev).requires_grad_() for n, v in leaves.items()}
        L.launches.clear()
        x, z = csr_fused_2d_train(yp.to(dev), lv["A"], lv["B"], lv["t"], c.to(dev), stride=2,
                                  **{n: lv[n] for n in names})
        grads = torch.autograd.grad([x, z], list(lv.values()), [g.to(dev) for g in cot])
        outs[str(dev)] = [a.detach().cpu() for a in (x, z, *grads)], dict(L.launches)
    (ref, _), (got, launched) = outs["cpu"], outs[str(cuda)]
    ana, adj = {0: ("lista2d_ana_threshold", "lista2d_syn_adjoint"),
                2: ("lista2d_ana_csr", "lista2d_syn_adjoint_csr"),
                4: ("lista2d_ana_csrf2", "lista2d_syn_adjoint_csrf2")}[len(names)]
    assert launched == {ana: K, "lista2d_syn_residual": 2 * K - 1, adj: K,
                        "lista2d_wgrad": 2 * K}
    for i, (a, b) in enumerate(zip(got, ref)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4, i


def test_2d_csr_adjoint_wrappers_reject_what_the_kernel_does_not_take(cuda):
    d, z, (u, tau, gam, code) = _setup_csr_adjoint(7, 2, 8, 1, 16, 16, "csr")
    args = [t.to(cuda) for t in (d["g"], d["ws_adj"], z, u, tau, gam, code)]
    with pytest.raises(ValueError, match="dzp"):
        LB2.lista2d_syn_adjoint_csr(*args, torch.zeros_like(args[2]).double(), d["geom"])
    with pytest.raises(ValueError, match="u"):
        LB2.lista2d_syn_adjoint_csr(*args[:3], args[3][:, :4], *args[4:],
                                    torch.zeros_like(args[2]), d["geom"])


# --- the input pipeline, the PCA estimator and residual blocks on the card ---

def test_device_prefetch_is_bitwise_under_a_concurrent_kernel(cuda):
    """device_prefetch copies on its side stream while a kernel runs on the
    consumer's stream between batches: every batch the consumer reads
    (a clone enqueued after that kernel) is its host batch bit for bit."""
    from cdlnet_tpu_torch.data.prefetch import device_prefetch

    rng = np.random.default_rng(11)
    batches = [rng.uniform(size=(2, 1, 16, 128, 128)).astype(np.float32) for _ in range(8)]
    w = torch.randn(4096, 4096, device=cuda)
    seen = []
    for batch in device_prefetch(batches, device=cuda):
        assert batch.device.type == "cuda" and batch.dtype == torch.float32
        for _ in range(3):
            w = torch.tanh(w @ w * 1e-3)
        seen.append(batch.clone())
    torch.cuda.synchronize()
    assert len(seen) == len(batches)
    for got, want in zip(seen, batches):
        assert torch.equal(got.cpu(), torch.from_numpy(want))


def test_batched_pca_on_the_card_matches_the_cpu(cuda):
    """nle_pca of a batch of gray images and of colour images on the card
    against the CPU: sigma and tau at rtol 1e-3, the selected-patch counts
    within 0.5% (a patch at the threshold can fall either way)."""
    from cdlnet_tpu_torch.nle.pca import nle_pca

    rng = np.random.default_rng(12)
    for shape in ((4, 1, 96, 80), (2, 3, 64, 64)):
        N = shape[0]
        clean = 0.5 + 0.2 * np.sin(np.linspace(0, 8, shape[-1]) + rng.uniform(0, 6, (N, 1, 1, 1)))
        sig = np.linspace(10, 50, N).reshape(-1, 1, 1, 1) / 255.0
        y = torch.from_numpy((clean + sig * rng.standard_normal(shape)).astype(np.float32))
        want = nle_pca(y)
        got = [v.cpu() for v in nle_pca(y.to(cuda))]
        for a, b, rtol in zip(got, want, (1e-3, 1e-3, 5e-3)):
            assert a.shape == b.shape == (N, shape[1])
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol)


def test_residual_golden_on_the_card(cuda):
    """CDLNetVideo with residual blocks on the card, backend "cuda": the
    reference golden at the JAX golden tolerance, through the plain loop
    (no hand-kernel launch)."""
    import os

    from cdlnet_tpu_torch.compat.jax_params import load_jax_params
    from cdlnet_tpu_torch.models import CDLNetVideo

    data = np.load(os.path.join(os.path.dirname(__file__), "golden", "cdlnet3d_res.npz"))
    sd = {k[4:]: data[k] for k in data.files if k.startswith("sd::")}
    params = {"A": np.stack([sd[f"A.{k}.weight"] for k in range(2)]),
              "B": np.stack([sd[f"B.{k}.weight"] for k in range(2)]), "t": sd["t"],
              "residual": {c: np.stack([sd[f"residual_blocks.{k}.{c}.weight"]
                                        for k in range(2)]) for c in ("conv1", "conv2")}}
    model = load_jax_params(CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=1, C=1, adaptive=True,
                                        residual=True, backend="cuda"), params).to(cuda)
    L.launches.clear()
    with torch.no_grad():
        xhat, z = model(torch.from_numpy(data["x"]).to(cuda), float(data["sigma"]),
                        return_z=True)
    torch.cuda.synchronize()
    assert not L.launches
    np.testing.assert_allclose(xhat.cpu().numpy(), data["xhat"], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(z.cpu().numpy(), data["z"], rtol=1e-4, atol=5e-5)


def _depth_sharded_rank(out):
    """One of two ranks sharing the card over gloo: the depth-sharded kernel
    forward of a small CDLNetVideo against the unsharded kernels, and its
    per-rank launches. Run by the test below as `python
    tests/test_torch_cuda.py depth <outdir>`."""
    import os

    import torch.distributed as dist

    from cdlnet_tpu_torch.core.preprocess import pre_process_3d
    from cdlnet_tpu_torch.dist import (
        initialize_distributed,
        make_mesh,
        sharded_lista_3d_fused_forward,
    )
    from cdlnet_tpu_torch.dist.init import shutdown_distributed
    from cdlnet_tpu_torch.models import CDLNetVideo

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(backend="gloo", device="cuda")
    dev = torch.device("cuda")
    model = CDLNetVideo(K=4, M=13, P=(7, 7, 5), s=2, adaptive=True, backend="cuda").to(dev)
    model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.t.copy_(torch.rand(model.t.shape, generator=torch.Generator().manual_seed(1))
                      .to(dev) * 0.05)
    y = torch.rand(2, 1, 16, 32, 48, generator=torch.Generator().manual_seed(2)).to(dev)
    ypc, _, _ = pre_process_3d(y, 2)
    with torch.no_grad():
        ref, zr = L.lista3d_fused(ypc, model.A, model.B, model.t, 25.0 / 255, stride=2)
        L.launches.clear()
        got, zg = sharded_lista_3d_fused_forward(model, ypc, 25.0, mesh=make_mesh({"depth": 2}),
                                                 return_z=True)
        torch.cuda.synchronize()
    torch.save({"rel": float((got - ref).abs().max() / ref.abs().max()),
                "rel_z": float((zg - zr).abs().max() / zr.abs().max()),
                "launches": dict(L.launches)},
               os.path.join(out, f"rank{dist.get_rank()}.pt"))
    shutdown_distributed()


def test_two_rank_gloo_depth_sharded_forward_on_the_card(cuda, tmp_path):
    """Two processes share the card over gloo (the halos staged through the
    host): the depth-sharded kernel forward (dist/halo_fused.py) against
    the unsharded kernel forward, 2K launches a rank."""
    import os
    import sys

    from cdlnet_tpu_torch.dist.launch import launch_local

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    rcs, outs = launch_local([sys.executable, os.path.abspath(__file__), "depth", str(tmp_path)],
                             2, env=env, timeout=600)
    assert rcs == [0, 0], "\n".join(outs)
    for r in (0, 1):
        res = torch.load(os.path.join(str(tmp_path), f"rank{r}.pt"))
        assert res["rel"] <= 1e-4 and res["rel_z"] <= 1e-4, res
        assert res["launches"] == {"lista3d_ana_threshold": 4, "lista3d_syn_residual": 4}


if __name__ == "__main__":
    import sys

    if sys.argv[1] == "depth":
        _depth_sharded_rank(sys.argv[2])


# the stride-1 3D banks at P = (7, 7, 5) (args3dt.json's config): 245 taps,
# whose synthesis and weight-gradient stages exceed a block's shared memory,
# so each runs as launches over halves of its depth taps
STRIDE1_SHAPES = [
    ((7, 7, 5), 1, 16, 1, 8, 12, 40, 1),
    ((7, 7, 5), 1, 64, 2, 6, 16, 64, 1),
]


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", STRIDE1_SHAPES)
@pytest.mark.parametrize("residual", ["none", "mask and y"])
def test_stride1_synthesis_over_depth_tap_halves_matches_plain(cuda, P, s, M, N, D, H, W, C,
                                                               residual):
    d = _setup(P, s, M, N, D, H, W, C)
    mask, y = (d["mask"], d["y"]) if residual != "none" else (None, None)
    ref = L.lista3d_syn_residual_plain(d["z"], d["ws"], d["geom"], mask=mask, y=y)
    hist = torch.full((2, *ref.shape), float("nan"), device=cuda)
    L.launches.clear()
    got = L.lista3d_syn_residual(
        d["z"].to(cuda), d["ws"].to(cuda), d["geom"],
        mask=None if mask is None else mask.to(cuda),
        y=None if y is None else y.to(cuda), out=hist[1])
    torch.cuda.synchronize()
    assert got.data_ptr() == hist[1].data_ptr() and torch.isnan(hist[0]).all()
    assert dict(L.launches) == {"lista3d_syn_residual": 2}
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", STRIDE1_SHAPES)
@pytest.mark.parametrize("form", ["dA", "dB-swapped"])
@pytest.mark.parametrize("on_rows", [False, True])
def test_stride1_wgrad_over_depth_tap_halves_matches_plain(cuda, P, s, M, N, D, H, W, C, form,
                                                           on_rows):
    d = _setup(P, s, M, N, D, H, W, C)
    geom = d["geom"]
    rows = LB.phase_rows(geom, d["wa"].shape[0], 3) if on_rows else None
    x = d["r"] if form == "dA" else d["y"]
    ref = LB.lista3d_wgrad_plain(x, d["z"], d["taps"], geom.off_a, alpha=-1.0, rows=rows)
    L.launches.clear()
    got = LB.lista3d_wgrad(x.to(cuda), d["z"].to(cuda), d["taps"], geom.off_a, alpha=-1.0,
                           rows=rows)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert L.launches["lista3d_wgrad"] >= 2
    assert _rel(got, ref) <= 1e-5


def test_stride1_grad_on_cuda_matches_cpu(cuda, monkeypatch):
    """args3dt's banks (s = 1, P = (7, 7, 5)) through the kernel forward and
    reverse: the CPU reverse loop's gradients."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")  # the kernels' fp32 histories
    rng = np.random.default_rng(8)
    K, M, P, s = 2, 8, (7, 7, 5), 1
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    yp, tgt = 0.3 * f(1, 1, 6, 16, 20), f(1, 1, 6, 16, 20)
    A, B = 0.05 * f(K, M, 1, *P), 0.05 * f(K, M, 1, *P)
    t = 0.02 * f(K, 2, M, 1, 1, 1).abs()

    def grads(dev):
        prm = [v.to(dev).requires_grad_() for v in (A, B, t)]
        x = lista3d_fused_diff(yp.to(dev), *prm, 0.1, stride=s)
        loss = ((x - tgt.to(dev)) ** 2).mean()
        return [g.cpu() for g in torch.autograd.grad(loss, prm)]

    for g, w in zip(grads(cuda), grads("cpu")):
        assert _rel(g, w) <= 1e-4


def test_epoch_runner_graph_replays_equal_the_eager_runner(cuda):
    """train/device_data.py on the card: a 2D CDLNet on the kernels, one
    epoch of the eager runner and one of the captured step's replays from
    the same state and seed, then a second epoch each after set_lr: losses,
    parameters and Adam state bitwise, and no launch through the wrappers
    during the replays."""
    from cdlnet_tpu_torch.models import CDLNet
    from cdlnet_tpu_torch.train.device_data import DeviceImageCorpus, make_epoch_runner
    from cdlnet_tpu_torch.train.fit import make_train_step
    from cdlnet_tpu_torch.train.optim import make_optimizer, set_lr

    rng = np.random.default_rng(3)
    images = [rng.uniform(0, 1, (1, 40, 52) if i % 2 else (1, 52, 40)).astype(np.float32)
              for i in range(9)]
    corpus = DeviceImageCorpus(images, 32, 3, device=cuda)
    model = CDLNet(K=3, M=12, P=5, s=2, adaptive=True, backend="pallas").to(cuda)
    model.init(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(1e-3, clip_grad=0.05)
    out = {}
    for graph in (False, True):
        model.load_state_dict(init)
        st = opt.init(dict(model.named_parameters()))
        step, _ = make_train_step(model, opt, workload="2d", noise_std=(20, 30))
        runner = make_epoch_runner(corpus, step, model, graph=graph)
        g = torch.Generator(device=cuda).manual_seed(5)
        losses = [runner(st, g)]
        set_lr(st, 5e-4)
        L.launches.clear()
        losses.append(runner(st, g))
        if graph:
            assert not L.launches and runner.capture_ms > 0
        out[graph] = (torch.cat(losses).cpu(), [p.detach().clone() for p in model.parameters()],
                      [st["count"].clone(), *(t.clone() for t in st["mu"].values())])
    (la, pa, sa), (lb, pb, sb) = out[False], out[True]
    assert torch.isfinite(la).all() and torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert all(torch.equal(a, b) for a, b in zip(sa, sb)) and int(sb[0]) == 6


def test_epoch_runner_captured_under_a_cuda_profile_records_its_spans(cuda):
    """utils.trace_span under a CUDA-only torch.profiler session (the
    benchmark's): an epoch runner captured and replayed inside it records
    per epoch one train_epoch_scan holding train_epoch_begin, a
    train_epoch_step a step and train_epoch_losses, the capture's forward
    spans outside any epoch, spans of another thread too, and the same
    losses as a runner captured with no profiler."""
    import contextlib
    import threading

    from cdlnet_tpu_torch import utils
    from cdlnet_tpu_torch.models import CDLNet
    from cdlnet_tpu_torch.train.device_data import DeviceImageCorpus, make_epoch_runner
    from cdlnet_tpu_torch.train.fit import make_train_step
    from cdlnet_tpu_torch.train.optim import make_optimizer

    rng = np.random.default_rng(4)
    images = [rng.uniform(0, 1, (1, 40, 52)).astype(np.float32) for _ in range(9)]
    corpus = DeviceImageCorpus(images, 32, 3, device=cuda)
    model = CDLNet(K=3, M=12, P=5, s=2, adaptive=True, backend="pallas").to(cuda)
    model.init(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(1e-3, clip_grad=0.05)

    def other_thread():
        with utils.trace_span("other"):
            pass

    losses = {}
    for traced in (False, True):
        model.load_state_dict(init)
        st = opt.init(dict(model.named_parameters()))
        step, _ = make_train_step(model, opt, workload="2d", noise_std=(20, 30))
        runner = make_epoch_runner(corpus, step, model)
        g = torch.Generator(device=cuda).manual_seed(5)
        utils.clear_spans()
        session = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                   if traced else contextlib.nullcontext())
        with session:
            losses[traced] = torch.cat([runner(st, g), runner(st, g)]).cpu()
            other = threading.Thread(target=other_thread)
            other.start()
            other.join(timeout=10)
        assert not other.is_alive()
        spans = utils.recorded_spans()
        utils.clear_spans()
    assert torch.isfinite(losses[True]).all() and torch.equal(losses[False], losses[True])
    roots = [i for i, s in enumerate(spans) if s[3] == -1]
    names = [spans[i][0] for i in roots]
    assert names.count("train_epoch_scan") == 2 and names[-1] == "other"
    assert {"lista2d_operands", "lista2d_loop"} <= set(names)  # the capture's forward
    for i in roots:
        if spans[i][0] == "train_epoch_scan":
            kids = [s[0] for s in spans if s[3] == i]
            assert kids == (["train_epoch_begin"] + ["train_epoch_step"] * runner.steps
                            + ["train_epoch_losses"])


def test_clipped_adam_on_device_state_matches_its_cpu_trajectory(cuda):
    """The optimizer's count and hyperparameters live on the parameters'
    device: five clipped steps (an lr change after the second) on the card
    track the same steps on the CPU."""
    from cdlnet_tpu_torch.train.optim import get_lr, make_optimizer, set_lr

    rng = np.random.default_rng(2)
    shapes = {"A": (3, 4, 1, 5, 5), "t": (3, 2, 4, 1, 1)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    runs = {}
    for dev in ("cpu", cuda):
        opt = make_optimizer(1e-2, clip_grad=0.5)
        params = {k: torch.from_numpy(v.copy()).to(dev) for k, v in p0.items()}
        st = opt.init(params)
        assert st["count"].device.type == torch.device(dev).type
        for i, g in enumerate(grads):
            opt.update(params, {k: torch.from_numpy(v).to(dev) for k, v in g.items()}, st)
            if i == 1:
                set_lr(st, 3e-3)
        assert int(st["count"]) == 5 and get_lr(st) == 3e-3
        runs[str(dev)] = (params, st)
    (pc, sc), (pg, sg) = runs["cpu"], runs[str(cuda)]
    for k in shapes:
        for a, b in ((pg[k], pc[k]), (sg["mu"][k], sc["mu"][k]), (sg["nu"][k], sc["nu"][k])):
            assert _rel(a, b) <= 1e-6


# --- bf16 training histories (kernels/lista3d.py::hist_dtype): the writers'
# rounded copies, the readers' bf16 operands, the loops in both modes ---

BF16 = torch.bfloat16
# (dims, shape): the 3D pair at the flagship serve and train shapes and at a
# ragged 427-wide code grid; the 2D pair at the flagship 10 x 128^2 train
# shape and a ragged width with two images
WRITER_CASES = [
    (3, ((7, 7, 5), 2, 169, 1, 16, 128, 128, 1)),
    (3, ((7, 7, 5), 2, 169, 2, 16, 128, 128, 1)),
    (3, ((7, 7, 5), 2, 24, 1, 4, 20, 854, 1)),
    (2, (7, 2, 169, 10, 128, 128, 1)),
    (2, (7, 2, 20, 2, 40, 150, 1)),
]


def _bf16_slot(shape, dev, off_grid):
    """A bf16 tensor of `shape` on dev, 2 bytes off the 16-byte grid where
    off_grid (the scalar epilogue's path)."""
    n = int(np.prod(shape))
    buf = torch.full((n + 1,), float("nan"), dtype=BF16, device=dev)
    return buf[1:].view(shape) if off_grid else buf[:n].view(shape)


def _pair(dims, shape, cuda):
    if dims == 3:
        d = _setup(*shape)
        ana, syn, adj = L.lista3d_ana_threshold, L.lista3d_syn_residual, LB.lista3d_syn_adjoint
        ws_adj = d["ws_adj"]
    else:
        d = _setup2d(*shape)
        ana, syn, adj = L2.lista2d_ana_threshold, L2.lista2d_syn_residual, LB2.lista2d_syn_adjoint
        ws_adj = LB.adjoint_bank(d["ws"], 2)
    g = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in d.items()}
    g["ws_adj"] = ws_adj.to(cuda)
    return g, ana, syn, adj


@pytest.mark.parametrize("dims,shape", WRITER_CASES)
@pytest.mark.parametrize("writer", ["analysis", "synthesis"])
@pytest.mark.parametrize("off_grid", [False, True])
def test_bf16_writers_store_the_rounded_fp32_output(cuda, dims, shape, writer, off_grid):
    """With a bf16 history slice the writer's fp32 output is bitwise the
    launch without it, and the slice holds that output rounded to nearest
    even (torch's own rounding), on and off the 16-byte grid."""
    d, ana, syn, _ = _pair(dims, shape, cuda)
    if writer == "analysis":
        call = lambda **kw: ana(d["r"], d["z"], d["wa"], d["tau"], d["geom"], **kw)
    else:
        call = lambda **kw: syn(d["z"], d["ws"], d["geom"], mask=d["mask"], y=d["y"], **kw)
    ref = call()
    hist = _bf16_slot(ref.shape, cuda, off_grid)
    got = call(hist=hist)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(hist, ref.to(BF16))


@pytest.mark.parametrize("dims,shape", WRITER_CASES)
@pytest.mark.parametrize("with_base,alpha", [(False, 1.0), (True, -1.0)])
@pytest.mark.parametrize("off_grid", [False, True])
def test_bf16_syn_adjoint_is_the_launch_on_the_upcast_codes(cuda, dims, shape, with_base,
                                                            alpha, off_grid):
    """The synthesis adjoint on bf16 codes: dv and dtau bitwise the same
    launch on z.float() (it reads the codes' zeros and signs only)."""
    d, _, _, adj = _pair(dims, shape, cuda)
    z16 = _bf16_slot(d["z"].shape, cuda, off_grid)
    z16.copy_(d["z"])
    base = (0.5 * d["z"] + 0.1) if with_base else None
    ref = adj(d["y"], d["ws_adj"], z16.float(), d["geom"], base=base, alpha=alpha)
    got = adj(d["y"], d["ws_adj"], z16, d["geom"], base=base, alpha=alpha)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float32
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


# the weight gradient with a bf16 operand: the flagship train shape, a
# 427-wide code grid and a 20-wide one (whole 16-byte units in fp32, not in
# bf16: the aligned fp32 operand beside a ragged bf16 one), the stride-1
# P = (7, 7, 5) bank (launched over halves of its depth taps)
WGRAD_BF16_SHAPES = [
    ((7, 7, 5), 2, 169, 2, 16, 128, 128, 1),
    ((7, 7, 5), 2, 24, 1, 4, 20, 854, 1),
    ((5, 5, 3), 2, 32, 2, 8, 16, 40, 1),
    ((7, 7, 5), 1, 8, 1, 6, 16, 20, 1),
]


@pytest.mark.parametrize("P,s,M,N,D,H,W,C", WGRAD_BF16_SHAPES)
@pytest.mark.parametrize("form", ["dA: x = r", "dB: y = z"])
@pytest.mark.parametrize("on_rows,off_grid", [(False, False), (True, False), (True, True)])
def test_bf16_wgrad_matches_plain_on_the_upcast_history(cuda, P, s, M, N, D, H, W, C, form,
                                                        on_rows, off_grid):
    d = _setup(P, s, M, N, D, H, W, C)
    geom = d["geom"]
    rows = LB.phase_rows(geom, d["wa"].shape[0], 3) if on_rows else None
    hist = d["r"] if form.startswith("dA") else d["z"]
    h16 = _bf16_slot(hist.shape, cuda, off_grid)
    h16.copy_(hist)
    x, y = (h16, d["z"].to(cuda)) if form.startswith("dA") else (d["y"].to(cuda), h16)
    ref = LB.lista3d_wgrad_plain(x.cpu().float(), y.cpu().float(), d["taps"], geom.off_a,
                                 alpha=-1.0, rows=rows)
    got = LB.lista3d_wgrad(x, y, d["taps"], geom.off_a, alpha=-1.0, rows=rows)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("shape", [(7, 2, 169, 10, 128, 128, 1), (7, 2, 20, 2, 40, 150, 1),
                                   (7, 1, 16, 1, 24, 36, 3)])
@pytest.mark.parametrize("form", ["dA: x = r", "dB: y = z"])
def test_bf16_2d_wgrad_matches_plain_on_the_upcast_history(cuda, shape, form):
    d = _setup2d(*shape)
    geom, taps = d["geom"], tuple(d["wa"].shape[1:3])
    rows = LB.phase_rows(geom, d["wa"].shape[0], 2)
    if form.startswith("dA"):
        x, y = d["r"].to(BF16), d["z"]
    else:
        x, y = d["y"], d["z"].to(BF16)
    ref = LB2.lista2d_wgrad_plain(x.float(), y.float(), taps, geom.off_a, alpha=-1.0, rows=rows)
    got = LB2.lista2d_wgrad(x.to(cuda), y.to(cuda), taps, geom.off_a, alpha=-1.0, rows=rows)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-5


def _fused_operands(dims, rng, K=3, M=13):
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    shape = (2, 1, 8, 16, 24) if dims == 3 else (2, 1, 24, 40)
    P = (7, 7, 5) if dims == 3 else (7, 7)
    yp = 0.3 * f(*shape)
    A, B = 0.1 * f(K, M, 1, *P), 0.1 * f(K, M, 1, *P)
    t = 0.02 * f(K, 2, M, *(1,) * dims).abs()
    c = torch.tensor([0.1, 0.2]).reshape(2, *(1,) * (dims + 1))
    mask = (f(*shape) > 0).float()
    return yp, A, B, t, c, mask


@pytest.mark.parametrize("dims", [3, 2])
def test_bf16_fused_forward_is_the_f32_modes_with_rounded_histories(cuda, dims):
    """The loop in bf16 mode on the card: output and codes bitwise the fp32
    mode's, histories the fp32 histories rounded, the same launches."""
    ops = [v.to(cuda) for v in _fused_operands(dims, np.random.default_rng(9))]
    fused = L.lista3d_fused if dims == 3 else L2.lista2d_fused
    kw = dict(stride=2, mask=ops[5], return_z=True)
    kw["return_hists" if dims == 3 else "return_hist"] = True
    out = {}
    for dtype in (torch.float32, BF16):
        L.launches.clear()
        out[dtype] = (*fused(*ops[:5], hists_dtype=dtype, **kw), dict(L.launches))
    (xf, zf, hf, lf), (xb, zb, hb, lb) = out[torch.float32], out[BF16]
    assert lf == lb
    assert torch.equal(xb, xf) and torch.equal(zb, zf)
    assert all(h.dtype == BF16 for h in hb)
    assert all(torch.equal(b, f.to(BF16)) for b, f in zip(hb, hf))


@pytest.mark.parametrize("dims", [3, 2])
def test_bf16_grad_on_cuda_matches_cpu_and_the_f32_mode(cuda, dims, monkeypatch):
    """The default (bf16) gradients on the card: within 1e-3 of the CPU's
    bf16 gradients (the same rounded histories but where fp32 sums round
    to another bf16 neighbour), within the JAX package's 1e-1 of the fp32
    mode's, with the fp32 mode's launches."""
    from cdlnet_tpu_torch.kernels.autodiff import lista2d_fused_diff

    yp, A, B, t, c, mask = _fused_operands(dims, np.random.default_rng(10))
    tgt = torch.from_numpy(np.random.default_rng(11).uniform(size=yp.shape).astype(np.float32))
    diff = lista3d_fused_diff if dims == 3 else lista2d_fused_diff

    def grads(dev, dtype):
        monkeypatch.setenv("CDLNET_HIST_DTYPE", dtype)
        prm = [v.to(dev).requires_grad_() for v in (A, B, t)]
        L.launches.clear()
        x = diff(yp.to(dev), *prm, c.to(dev), stride=2, mask=mask.to(dev))
        loss = ((x - tgt.to(dev)) ** 2).mean()
        return [g.cpu() for g in torch.autograd.grad(loss, prm)], dict(L.launches)

    (gb, lb), (gf, lf) = grads(cuda, "bf16"), grads(cuda, "f32")
    cpu, _ = grads("cpu", "bf16")
    assert lb == lf
    for name, b, f, w in zip("ABt", gb, gf, cpu):
        assert _rel(b, w) <= 1e-3, name
        assert _rel(b, f) <= 1e-1, name


def test_bf16_operands_only_where_the_kernels_take_them(cuda):
    """A bf16 tensor where no history goes, two bf16 weight-gradient
    operands, or an fp32 history slice: ValueError, before any launch."""
    d = _setup((5, 5, 3), 2, 8, 1, 8, 16, 16)
    g = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in d.items()}
    with pytest.raises(ValueError):
        L.lista3d_ana_threshold(g["r"].to(BF16), None, g["wa"], g["tau"], g["geom"])
    with pytest.raises(ValueError):
        L.lista3d_ana_threshold(g["r"], None, g["wa"], g["tau"], g["geom"],
                                hist=torch.empty_like(g["z"]))
    with pytest.raises(ValueError):
        L.lista3d_syn_residual(g["z"].to(BF16), g["ws"], g["geom"])
    with pytest.raises(ValueError):
        LB.lista3d_wgrad(g["r"].to(BF16), g["z"].to(BF16), g["taps"], g["geom"].off_a)
    with pytest.raises(ValueError):
        LB.lista3d_syn_adjoint(g["y"].to(BF16), g["ws_adj"], g["z"], g["geom"])


# --- the CSR models' bf16 histories: the CSR analyses' rounded copies, the
# CSR adjoints on bf16 codes and prox arguments, the CSR loop and training ---

def _csr_analysis_args(P, s, M, N, H, W, two_sided, cuda):
    d, zp, za, gam1, gam2 = _csr_operands(P, s, M, N, H, W)
    if two_sided:
        name, args = "lista2d_ana_csrf2", (d["r"], 0.5 * zp, d["wa"], d["tau"], gam1, gam2,
                                           zp, za)
    else:
        name, args = "lista2d_ana_csr", (d["r"], 0.5 * zp, d["wa"], d["tau"], gam1, zp)
    return name, tuple(a.to(cuda) for a in args), d["geom"]


@pytest.mark.parametrize("P,s,M,N,H,W", SHAPES_CSR)
@pytest.mark.parametrize("two_sided", [False, True], ids=["csr", "csrf2"])
@pytest.mark.parametrize("off_grid", [False, True])
def test_bf16_csr_analyses_store_the_rounded_codes_and_prox_argument(cuda, P, s, M, N, H, W,
                                                                     two_sided, off_grid):
    """With a bf16 history slice the CSR analysis's fp32 codes are bitwise
    the launch without it, the slice holds them rounded to nearest even,
    and the bf16 u_out the fp32 launch's prox argument rounded, on and off
    the 16-byte grid; the bf16 launch counts in hist_launches."""
    name, args, geom = _csr_analysis_args(P, s, M, N, H, W, two_sided, cuda)
    u32 = torch.empty_like(args[1])
    ref = getattr(L2, name)(*args, geom, u_out=u32)
    hist = _bf16_slot(ref.shape, cuda, off_grid)
    u16 = _bf16_slot(ref.shape, cuda, off_grid)
    L.launches.clear()
    L.hist_launches.clear()
    got = getattr(L2, name)(*args, geom, u_out=u16, hist=hist)
    torch.cuda.synchronize()
    assert dict(L.launches) == dict(L.hist_launches) == {name: 1}
    assert torch.equal(got, ref)
    assert torch.equal(hist, ref.to(BF16)) and torch.equal(u16, u32.to(BF16))


@pytest.mark.parametrize("P,s,M,N,H,W", SHAPES_CSR[:2])
@pytest.mark.parametrize("two_sided", [False, True], ids=["csr", "csrf2"])
def test_bf16_csr_analysis_takes_u_out_in_the_historys_dtype(cuda, P, s, M, N, H, W,
                                                             two_sided):
    """u_out is bf16 exactly where a bf16 history is given: an fp32 u_out
    beside a history, a bf16 one without it, or an fp32 history raise
    before any launch."""
    name, args, geom = _csr_analysis_args(P, s, M, N, H, W, two_sided, cuda)
    f32, b16 = torch.empty_like(args[1]), torch.empty_like(args[1], dtype=BF16)
    L.launches.clear()
    for kw in (dict(u_out=f32, hist=b16.clone()), dict(u_out=b16),
               dict(u_out=b16.clone(), hist=f32.clone())):
        with pytest.raises(ValueError):
            getattr(L2, name)(*args, geom, **kw)
    assert not L.launches


@pytest.mark.parametrize("P,s,M,N,H,W", SHAPES_CSR)
@pytest.mark.parametrize("mode", ["csr", "z_after alone", "csrf2"])
@pytest.mark.parametrize("with_base,off_grid", [(False, False), (True, False), (True, True)])
def test_bf16_csr_adjoint_is_the_launch_on_the_upcast_histories(cuda, P, s, M, N, H, W, mode,
                                                                with_base, off_grid):
    """The CSR adjoints on bf16 codes and prox arguments: every output and
    the cotangent buffers bitwise the same launch on z.float() and
    u.float() (the epilogue upcasts them where it loads them), and the
    plain version's on the same bf16 operands within 1e-4, on and off the
    16-byte grid."""
    d, z, ops = _setup_csr_adjoint(P, s, M, N, H, W, mode)
    name = "lista2d_syn_adjoint_csrf2" if mode == "csrf2" else "lista2d_syn_adjoint_csr"
    base = d["base"] if with_base else None
    codes = ops[-(2 if mode == "csrf2" else 1):]
    z16, u16 = (_bf16_slot(z.shape, cuda, off_grid).copy_(t) for t in (z, ops[0]))
    rest = [t.to(cuda) for t in ops[1:]]  # tau, the gamma banks, the codes

    def call(zz, uu):
        bufs = [0.5 * c.to(cuda) for c in codes]
        got = getattr(LB2, name)(d["g"].to(cuda), d["ws_adj"].to(cuda), zz, uu, *rest, *bufs,
                                 d["geom"], base=None if base is None else base.to(cuda),
                                 alpha=-1.0)
        return (*got, *bufs)

    L.hist_launches.clear()
    got = call(z16, u16)
    assert dict(L.hist_launches) == {name: 1}
    ref = call(z16.float(), u16.float())
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    pbufs = [0.5 * c for c in codes]
    plain = getattr(LB2, name + "_plain")(d["g"], d["ws_adj"], z16.cpu(), u16.cpu(), *ops[1:],
                                          *pbufs, d["geom"], base=base, alpha=-1.0)
    for a, b in zip(got, (*plain, *pbufs)):
        assert _rel(a, b) <= 1e-4


def test_bf16_csr_adjoint_rejects_mixed_histories(cuda):
    """z and u both fp32 or both bf16: a bf16 z with an fp32 u (or the
    reverse) raises before any launch."""
    d, z, ops = _setup_csr_adjoint(7, 2, 8, 1, 16, 16, "csr")
    args = [t.to(cuda) for t in (d["g"], d["ws_adj"], z, *ops)]
    L.launches.clear()
    for zz, uu in ((args[2].to(BF16), args[3]), (args[2], args[3].to(BF16))):
        with pytest.raises(ValueError, match="u: the CUDA kernel takes"):
            LB2.lista2d_syn_adjoint_csr(args[0], args[1], zz, uu, *args[4:],
                                        torch.zeros_like(args[2]), d["geom"])
    assert not L.launches


def _csr_fused_operands(rng, names, K=3, M=13, P=7, N=2):
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    yp = 0.3 * f(N, 1, 24, 40)
    leaves = dict(A=0.1 * f(K, M, 1, P, P), B=0.1 * f(K, M, 1, P, P),
                  t=0.02 * f(K, 2, M, 1, 1).abs())
    leaves.update({n: (f(N, M, 12, 20) if n.startswith("z") else 0.5 * f(K, 2, M, 1, 1).abs())
                   for n in names})
    c = torch.tensor([0.1, 0.2]).reshape(2, 1, 1, 1)
    cot = (f(N, 1, 24, 40), f(N, M, 12, 20))
    return yp, leaves, c, cot


CSR_NAMES = [(), ("z_prev", "g"), ("z_after", "g2"), ("z_prev", "z_after", "g", "g2")]


@pytest.mark.parametrize("names", CSR_NAMES, ids=["st", "z_prev", "z_after", "both"])
def test_bf16_csr_fused_forward_is_the_f32_modes_with_rounded_histories(cuda, names):
    """lista2d_fused's CSR modes in bf16 on the card: output and codes
    bitwise the fp32 mode's, the z, r and u histories its histories
    rounded, the same launches."""
    yp, leaves, c, _ = _csr_fused_operands(np.random.default_rng(12), names)
    ops = [v.to(cuda) for v in (yp, leaves["A"], leaves["B"], leaves["t"], c)]
    kw = {n: leaves[n].to(cuda) for n in names}
    out = {}
    for dtype in (torch.float32, BF16):
        L.launches.clear()
        out[dtype] = (*L2.lista2d_fused(*ops, stride=2, return_z=True, return_hist=True,
                                        hists_dtype=dtype, **kw), dict(L.launches))
    (xf, zf, hf, lf), (xb, zb, hb, lb) = out[torch.float32], out[BF16]
    assert lf == lb and len(hb) == len(hf) == (3 if names else 2)
    assert torch.equal(xb, xf) and torch.equal(zb, zf)
    assert all(b.dtype == BF16 and torch.equal(b, f.to(BF16)) for b, f in zip(hb, hf))


@pytest.mark.parametrize("names", CSR_NAMES, ids=["st", "z_prev", "z_after", "both"])
def test_bf16_csr_train_on_cuda_matches_the_f32_mode_and_cpu(cuda, names, monkeypatch):
    """csr_fused_2d_train at the default (bf16) on the card: x and z
    bitwise the f32 mode's, the same launches, every launch of the mode's
    analysis and adjoint a bf16 one; the parameters' gradients within 1e-3
    of the CPU's bf16 gradients and 1e-1 of the f32 mode's (the JAX
    package's bf16 gate); the carried codes' within 1e-3 of the CPU's over
    the codes whose prox branch is the same in the two devices' bf16 u
    histories (a code whose prox argument falls in another branch moves by
    its whole local gradient; fewer than 1e-3 of the codes flip)."""
    yp, leaves, c, cot = _csr_fused_operands(np.random.default_rng(13), names)

    def run(dev, dtype):
        monkeypatch.setenv("CDLNET_HIST_DTYPE", dtype)
        lv = {n: v.to(dev).requires_grad_() for n, v in leaves.items()}
        L.launches.clear()
        L.hist_launches.clear()
        x, z = csr_fused_2d_train(yp.to(dev), lv["A"], lv["B"], lv["t"], c.to(dev), stride=2,
                                  **{n: lv[n] for n in names})
        grads = torch.autograd.grad([x, z], list(lv.values()), [g.to(dev) for g in cot])
        counts = dict(L.launches), dict(L.hist_launches)
        with torch.no_grad():
            hists = L2.lista2d_fused(*(v.to(dev) for v in (yp, leaves["A"], leaves["B"],
                                                            leaves["t"], c)),
                                     stride=2, return_hist=True,
                                     **{n: leaves[n].to(dev) for n in names})[2]
        return ([a.detach().cpu() for a in (x, z)], [g.cpu() for g in grads], *counts,
                [h.cpu() for h in hists])

    (ob, gb, lb, hb, ub), (of, gf, lf, _, _) = run(cuda, "bf16"), run(cuda, "f32")
    _, gc, _, _, uc = run("cpu", "bf16")
    K = leaves["A"].shape[0]
    ana, adj = {0: ("lista2d_ana_threshold", "lista2d_syn_adjoint"),
                2: ("lista2d_ana_csr", "lista2d_syn_adjoint_csr"),
                4: ("lista2d_ana_csrf2", "lista2d_syn_adjoint_csrf2")}[len(names)]
    assert lb == lf
    assert hb[ana] == hb[adj] == K
    assert all(torch.equal(a, b) for a, b in zip(ob, of))
    flipped = torch.zeros(ob[1].shape, dtype=torch.bool)
    if names:
        bank = lambda b, k: L2.threshold_bank(b, c, 2, yp)[k][:, :, None, None]
        zp, za = leaves.get("z_prev", leaves.get("z_after")), leaves.get("z_after")
        za = za if "z_prev" in names else None
        g1 = leaves.get("g", leaves.get("g2"))
        for k in range(K):
            prox = (zp, za, bank(leaves["t"], k), bank(g1, k),
                    None if za is None else bank(leaves["g2"], k))
            flipped |= (csr_prox_branches(ub[2][k], *prox)
                        != csr_prox_branches(uc[2][k], *prox)).any(0)
        assert float(flipped.float().mean()) < 1e-3
    for name, b, f, w in zip(leaves, gb, gf, gc):
        if name.startswith("z"):
            assert float((b - w).abs()[~flipped].max() / w.abs().max()) <= 1e-3, name
        else:
            assert _rel(b, w) <= 1e-3, name
            assert _rel(b, f) <= 1e-1, name
