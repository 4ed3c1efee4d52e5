"""cdlnet_tpu_torch core/ and ops/ against their cdlnet_tpu counterparts:
the same numpy inputs through both packages, fp32, atol 1e-5."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cdlnet_tpu.core import ops as jops
from cdlnet_tpu.core import pad as jpad
from cdlnet_tpu.core import preprocess as jpre
from cdlnet_tpu.core.solvers import power_method as jpower
from cdlnet_tpu.ops import conv as jconv
from cdlnet_tpu.ops import polyphase as jpp
from cdlnet_tpu_torch.core import ops as tops
from cdlnet_tpu_torch.core import pad as tpad
from cdlnet_tpu_torch.core import preprocess as tpre
from cdlnet_tpu_torch.core.solvers import power_method as tpower
from cdlnet_tpu_torch.ops import conv as tconv
from cdlnet_tpu_torch.ops import polyphase as tpp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 1e-5


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.mark.parametrize("D,H,W,M", [(5, 11, 13, 4), (16, 8, 8, 2), (3, 7, 9, 2), (6, 9, 10, 3)])
def test_pad_matches_jax(D, H, W, M):
    x = _rand(0, 1, 2, D, H, W)
    pad = tpad.calc_pad_3d(D, H, W, M)
    assert pad == jpad.calc_pad_3d(D, H, W, M)
    xt = tpad.pad_reflect_3d(torch.from_numpy(x), pad)
    _close(xt, jpad.pad_reflect_3d(jnp.asarray(x), pad), atol=0)
    _close(tpad.unpad_3d(xt, pad), x, atol=0)


@pytest.mark.parametrize("use_mask", [False, True])
def test_preprocess_roundtrip_matches_jax(use_mask):
    x = _rand(1, 2, 1, 5, 11, 13)
    mask = (np.random.default_rng(2).uniform(size=x.shape) > 0.4).astype(np.float32)
    m = mask if use_mask else None
    yt, (mt, pt), mkt = tpre.pre_process_3d(
        torch.from_numpy(x), 2, None if m is None else torch.from_numpy(m))
    yj, (mj, pj), mkj = jpre.pre_process_3d(
        jnp.asarray(x), 2, None if m is None else jnp.asarray(m))
    assert pt == pj
    _close(yt, yj)
    _close(mt, mj)
    if use_mask:
        _close(mkt, mkj, atol=0)
    _close(tpre.post_process_3d(yt, (mt, pt)), jpre.post_process_3d(yj, (mj, pj)))


@pytest.mark.parametrize("t", [0.0, 0.3, "per-channel"])
def test_st_matches_jax(t):
    x = _rand(3, 2, 4, 3, 5, 5)
    if t == "per-channel":
        t = np.abs(_rand(4, 1, 4, 1, 1, 1))
        tt, tj = torch.from_numpy(t), jnp.asarray(t)
    else:
        tt = tj = t
    _close(tops.ST(torch.from_numpy(x), tt), jops.ST(jnp.asarray(x), tj))


@pytest.mark.parametrize("scale", [0.05, 3.0])
def test_uball_project_matches_jax(scale):
    W = scale * _rand(5, 2, 4, 1, 5, 5, 3)
    _close(tops.uball_project(torch.from_numpy(W), axes=(3, 4, 5)),
           jops.uball_project(jnp.asarray(W), axes=(3, 4, 5)))


def test_power_method_matches_jax():
    P, s, pad = (5, 5, 3), 2, (2, 2, 1)
    W = _rand(6, 4, 1, *P)
    b0 = np.abs(_rand(7, 1, 1, 4, 16, 16))

    def DDt(conv):
        def op(x, w):
            return conv.conv_transpose3d(conv.conv3d(x, w, stride=s, padding=pad), w,
                                         stride=s, padding=pad, output_padding=s - 1)
        return op

    top, jop = DDt(tconv), DDt(jconv)
    Wt, Wj = torch.from_numpy(W), jnp.asarray(W)
    Lt, bt, _ = tpower(lambda x: top(x, Wt), torch.from_numpy(b0), num_iter=60)
    Lj, bj, _ = jpower(lambda x: jop(x, Wj), jnp.asarray(b0), num_iter=60)
    assert abs(float(Lt) - float(Lj)) <= 1e-4 * abs(float(Lj))
    _close(bt, bj, atol=1e-4)


@pytest.mark.parametrize("s,nd_shape", [(2, (2, 3, 8, 6, 4)), (1, (1, 2, 3, 5, 7)),
                                        (3, (1, 1, 6, 9, 3))])
def test_space_to_depth_matches_jax(s, nd_shape):
    x = _rand(8, *nd_shape)
    xt = tpp.space_to_depth(torch.from_numpy(x), s, 3)
    _close(xt, jpp.space_to_depth(jnp.asarray(x), s, 3), atol=0)
    _close(tpp.depth_to_space(xt, s, 3, nd_shape[1]), x, atol=0)


@pytest.mark.parametrize("P,s", [((7, 7, 5), 2), ((5, 5, 3), 2), ((9, 9, 5), 2),
                                 ((3, 3, 3), 1)])
def test_polyphase_weights_match_jax(P, s):
    W = _rand(9, 2, 3, 1, *P)
    pads = tuple(p // 2 for p in P)
    for i in range(3):
        assert tpp._tap_ranges(P[i], pads[i], s) == jpp._tap_ranges(P[i], pads[i], s)
    At, Bt, pat, pst = tpp.polyphase_weights(torch.from_numpy(W), s, pads, 3)
    Aj, Bj, paj, psj = jpp.polyphase_weights(jnp.asarray(W), s, pads, 3)
    assert (pat, pst) == (paj, psj)
    _close(At, Aj, atol=0)
    _close(Bt, Bj, atol=0)


@pytest.mark.parametrize("s", [1, 2])
def test_conv_pair_matches_jax(s):
    P, pad = (7, 7, 5), (3, 3, 2)
    x = _rand(10, 2, 1, 8, 12, 10)
    W = 0.02 * _rand(11, 6, 1, *P)  # outputs O(1), so atol 1e-5 is ~1e-5 relative
    zt = tconv.conv3d(torch.from_numpy(x), torch.from_numpy(W), stride=s, padding=pad)
    zj = jconv.conv3d(jnp.asarray(x), jnp.asarray(W), stride=s, padding=pad)
    _close(zt, zj)
    _close(tconv.conv_transpose3d(zt, torch.from_numpy(W), stride=s, padding=pad,
                                  output_padding=s - 1),
           jconv.conv_transpose3d(zj, jnp.asarray(W), stride=s, padding=pad,
                                  output_padding=s - 1))
