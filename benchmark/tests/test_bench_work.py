"""The work count (benchmark/work.py) against the hand arithmetic."""

import bench_tiny  # noqa: F401  (sys.path)
import pytest

import work

VIDEO = dict(K=30, M=169, P=[7, 7, 5], s=2, C=1, depth=16)
IMAGE = dict(K=30, M=169, P=7, s=2, C=1)


@pytest.mark.parametrize("model, spatial, conv, forward", [
    (VIDEO, (16, 128, 128), 2.714e9, 162.8e9),   # 169 x 245 x 8*64*64 MACs
    (IMAGE, (128, 128), 67.8e6, 4.07e9),
    (IMAGE, (321, 481), 642.6e6, 38.56e9),       # 161 x 241 code positions; 60 convs
    (IMAGE, (481, 321), 642.6e6, 38.56e9),
])
def test_flops_by_hand(model, spatial, conv, forward):
    assert work.conv_flops(model, spatial) == pytest.approx(conv, rel=1e-3)
    assert work.forward_flops(model, spatial) == pytest.approx(forward, rel=1e-3)
    assert work.train_sample_flops(model, spatial) == 3 * work.forward_flops(model, spatial)


def test_positions_are_the_inputs_own_over_the_stride():
    assert work.code_positions((321, 481), 2) == 161 * 241
    assert work.code_positions((16, 128, 128), 2) == 8 * 64 * 64


def test_video_step_and_bounds():
    step = 2 * work.train_sample_flops(VIDEO, (16, 128, 128))
    assert step == pytest.approx(977e9, rel=1e-3)
    nbytes = work.train_step_bytes(VIDEO, (16, 128, 128), 2)
    assert work.bound_by(step, nbytes) == "operations"
    assert work.roofline_s(step, nbytes) == pytest.approx(step / 495e12)
    # a clip served: 0.329 ms at the TF32 peak, operations-bound
    f, b = work.forward_flops(VIDEO, (16, 128, 128)), work.forward_bytes(VIDEO, (16, 128, 128))
    assert work.roofline_s(f, b) == pytest.approx(0.329e-3, rel=2e-3)
    assert work.bound_by(f, b) == "operations"
