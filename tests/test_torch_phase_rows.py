"""The weight gradient's phase-row mask (kernels/lista3d_bwd.py::phase_rows)
on the CPU: the rows the reverse loop computes are exactly the taps the
weight prep keeps, for dA and for the swapped dB form, in 2D and 3D; the
plain versions honour the mask; the kernel's row table partitions the rows
as the kernel needs; and the reverse loop with the mask gives the
gradients of A, B and t it gives without it, bit for bit.

Inputs come from numpy seeds; the equalities are exact (the masked rows
are zeros, the kept rows the dense version's own values)."""

import numpy as np
import pytest
import torch

from cdlnet_tpu_torch.kernels import lista2d as L2
from cdlnet_tpu_torch.kernels import lista2d_bwd as LB2
from cdlnet_tpu_torch.kernels import lista3d as L
from cdlnet_tpu_torch.kernels import lista3d_bwd as LB
from cdlnet_tpu_torch.kernels.autodiff import lista2d_fused_diff, lista3d_fused_diff
from cdlnet_tpu_torch.ops import polyphase as pp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (P, s, C): 3D geometries (the flagship's taps, the fastMRI config's, a
# stride-1 one, colour) and 2D ones (the flagship's, the CSR models' P=9,
# JDD's stride 1 with colour, stride 2 with colour)
GEOMS_3D = [((7, 7, 5), 2, 1), ((9, 9, 5), 2, 1), ((5, 5, 3), 1, 1), ((5, 5, 3), 2, 3)]
GEOMS_2D = [(7, 2, 1), (9, 2, 1), (7, 1, 3), (5, 2, 3)]


def _geom(P, s, nd):
    P = P if isinstance(P, tuple) else (P,) * nd
    return L.Geom(s, P, tuple(p // 2 for p in P))


def _preps(P, s, C, nd, M=5):
    """(geom, A's analysis bank, B's synthesis bank) of all-ones filters:
    nonzero exactly where the prep keeps a tap."""
    geom = _geom(P, s, nd)
    W = torch.ones((1, M, C, *geom.P))
    if nd == 3:
        return geom, L.prep_A2m_3d(W, s, geom.pads)[0], L.prep_B2m_3d(W, s, geom.pads)[0]
    return geom, L2.prep_A2m_2d(W, s, geom.pads)[0], L2.prep_B2m_2d(W, s, geom.pads)[0]


@pytest.mark.parametrize("nd,P,s,C", [(3, *g) for g in GEOMS_3D] + [(2, *g) for g in GEOMS_2D])
@pytest.mark.parametrize("form", ["dA", "dB swapped"])
def test_phase_rows_are_the_taps_the_prep_keeps(nd, P, s, C, form):
    """dA's rows (i, q) are A's bank entries (i, q, .); the swapped dB form
    computes wgrad(g, z) whose adjoint_bank is B's bank, so its rows are
    the adjoint_bank of B's kept entries."""
    geom, wa, ws = _preps(P, s, C, nd)
    rows = LB.phase_rows(geom, C * s**nd, nd)
    bank = wa if form == "dA" else LB.adjoint_bank(ws, nd)  # (Cp, *Q, M)
    assert rows.dtype == torch.bool and rows.device.type == "cpu"
    assert torch.equal(rows, bank[..., 0] != 0)
    assert torch.equal(bank != 0, rows[..., None].expand_as(bank))
    # the structurally zero rows: 139 of 384 at the flagship video taps,
    # 15 of 64 at the flagship image taps
    if (nd, P, s, C) == (3, (7, 7, 5), 2, 1):
        assert (rows.numel(), int(rows.sum())) == (384, 245)
    if (nd, P, s, C) == (2, 7, 2, 1):
        assert (rows.numel(), int(rows.sum())) == (64, 49)


def test_phase_rows_are_cached_and_match_the_prep_mask():
    geom = _geom((7, 7, 5), 2, 3)
    rows = LB.phase_rows(geom, 8, 3)
    assert LB.phase_rows(_geom((7, 7, 5), 2, 3), 8, 3) is rows
    valid = pp.phase_valid(geom.P, geom.pads, 2, 3)  # (2, 2, 2, Qd, Qh, Qw)
    assert torch.equal(rows, torch.from_numpy(valid.reshape(8, *valid.shape[3:])))


@pytest.mark.parametrize("nd,P,s,C", [(3, *GEOMS_3D[0]), (3, *GEOMS_3D[3]),
                                      (2, *GEOMS_2D[0]), (2, *GEOMS_2D[3])])
@pytest.mark.parametrize("form", ["dA", "dB swapped"])
def test_masked_plain_wgrad_keeps_the_dense_rows(nd, P, s, C, form):
    geom = _geom(P, s, nd)
    Cp, M = C * s**nd, 7
    rows = LB.phase_rows(geom, Cp, nd)
    taps = tuple(rows.shape[1:])
    rng = np.random.default_rng(0)
    grid = (4, 6, 10)[3 - nd:]
    f = lambda ch: torch.from_numpy(rng.standard_normal((2, ch, *grid)).astype(np.float32))
    x, y = f(Cp), f(M)  # dA: x = r, y = dv; dB swapped: x = g, y = z
    plain = LB.lista3d_wgrad_plain if nd == 3 else LB2.lista2d_wgrad_plain
    wgrad = LB.lista3d_wgrad if nd == 3 else LB2.lista2d_wgrad
    alpha = -1.0 if form == "dA" else 1.0
    dense = plain(x, y, taps, geom.off_a, alpha=alpha)
    masked = plain(x, y, taps, geom.off_a, alpha=alpha, rows=rows)
    assert torch.equal(masked[rows], dense[rows])
    assert not masked[~rows].any() and dense[~rows].abs().max() > 0
    # the wrapper runs the same plain version on CPU tensors
    assert torch.equal(wgrad(x, y, taps, geom.off_a, alpha=alpha, rows=rows), masked)


@pytest.mark.parametrize("shape,per_channel", [
    ((8, 4, 4, 3), None),     # the flagship video bank, every row
    ((8, 4, 4, 3), "prep"),   # its kept rows: 245 in two blocks
    ((4, 4, 4), "prep"),      # the flagship image bank's 49 rows: one block
    ((169, 4, 4, 3), None),   # a dB bank with the codes as input channels
    ((40, 1), None),          # one tap: the channel bound sets the blocks
    ((12, 3, 3), "sparse"),   # rows spread thin over the channels
])
def test_row_table_partitions_the_rows(shape, per_channel):
    if per_channel == "prep":
        nd = len(shape) - 1
        geom = _geom((7, 7, 5) if nd == 3 else 7, 2, nd)
        rows = LB.phase_rows(geom, shape[0], nd)
    elif per_channel == "sparse":
        rows = torch.from_numpy(np.random.default_rng(1).uniform(size=shape) > 0.8)
    else:
        rows = torch.ones(shape, dtype=torch.bool)
    table, R, RB = LB._row_table(rows, "cpu")
    table = table.numpy()
    IT = rows.numel()
    slot_of, slots, starts = table[:IT], table[IT:IT + R], table[IT + R:]
    flat = rows.reshape(-1).numpy()
    assert R == flat.sum() and len(starts) == RB + 1 and starts[0] == 0 and starts[-1] == R
    assert np.array_equal(slots, np.flatnonzero(flat))
    assert np.array_equal(slot_of[slots], np.arange(R)) and (slot_of[~flat] == -1).all()
    T = IT // shape[0]
    sizes = np.diff(starts)
    assert (sizes > 0).all() and (sizes <= LB.WGRAD_BLOCK_ROWS).all()
    for a, b in zip(starts[:-1], starts[1:]):
        assert slots[b - 1] // T - slots[a] // T < LB.WGRAD_BLOCK_CHANNELS
    # as few blocks as the row bound allows where the channel bound does
    # not bind (every case but the thin ones)
    if per_channel != "sparse" and T > 1:
        assert RB == -(-R // LB.WGRAD_BLOCK_ROWS)
    assert LB._row_table(rows, "cpu")[0] is LB._row_table(rows, "cpu")[0]  # cached


def _grads(fused, nd, geom_args, seed=0):
    """d(mse)/d(A, B, t) of one fused LISTA forward on CPU tensors."""
    (P, s, C), K, M = geom_args, 3, 6
    rng = np.random.default_rng(seed)
    P = P if isinstance(P, tuple) else (P,) * nd
    shape = (2, C, 8, 16, 16)[:2] + (8, 16, 16)[3 - nd:]
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    A = (0.1 * f(K, M, C, *P)).requires_grad_()
    B = (0.1 * f(K, M, C, *P)).requires_grad_()
    t = torch.from_numpy(rng.uniform(0, 0.05, (K, 2, M) + (1,) * nd).astype(np.float32))
    t = t.requires_grad_()
    y = f(*shape)
    c = torch.full((shape[0],) + (1,) * (nd + 1), 0.1)
    x = fused(y, A, B, t, c, stride=s)
    loss = ((x - y) ** 2).mean()
    return torch.autograd.grad(loss, (A, B, t))


@pytest.mark.parametrize("nd,geom", [(3, GEOMS_3D[0]), (3, GEOMS_3D[3]),
                                     (2, GEOMS_2D[0]), (2, GEOMS_2D[3])])
def test_reverse_loop_with_the_mask_gives_the_dense_gradients(nd, geom, monkeypatch):
    fused = lista3d_fused_diff if nd == 3 else lista2d_fused_diff
    masked = _grads(fused, nd, geom)
    monkeypatch.setattr(LB, "phase_rows", lambda *a: None)  # every row, as before the mask
    dense = _grads(fused, nd, geom)
    for a, b in zip(masked, dense):
        assert torch.equal(a, b)
