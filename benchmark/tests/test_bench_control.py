"""The correctness check fails what it has to fail, at a tiny size on the
CPU with each cell's own limits:

- the control: the reference put in the program's place and computed in
  TF32 (every convolution's operands rounded), the precision below the
  configurations' float32;
- the timed path broken underneath a whole run (the harness's look for a
  card skipped): an answer altered where it is produced (serving); a step
  that leaves its state unchanged, and half of each batch left out with
  the mean taken over the rest (training).

The same control at each cell's own size runs on the card through
benchmark/calibrate.py.
"""

import time

import bench_tiny
import numpy as np
import pytest
import torch

import calibrate
from benchlib import main as bench, train

CPU = torch.device("cpu")
SERVE = ["video-serve-16x128", "image-serve-481x321-blind"]  # the second: a kept mix
TRAIN = ["video-train-2x16x128", "image-train-10x128"]


@pytest.fixture(autouse=True)
def fp32_histories(monkeypatch):
    """The program's training histories in float32 here: at these tiny
    widths the default bf16 copies move a step's gradients by more (a
    change_gap of ~2e-5) than at the cells' own widths on the card, where
    the limits were set (~2e-6); the check's logic is what these runs
    hold."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")


def _run(spec, seed=2**31 + 3):
    run = bench.run_cell(spec, seed, 0.2, False, CPU, time.perf_counter())
    return run, bench.passed(bench.checks(run, spec["limits"]))


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_serve_control_fails(name, seed):
    spec = bench_tiny.tiny(name)
    reading = calibrate.serve_control(spec, seed, CPU)["max_abs_err"]
    assert reading > spec["limits"]["max_abs_err"]


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("variant", ["control", "half_batch"])
def test_train_control_and_half_batch_fail(name, variant):
    spec = bench_tiny.tiny(name)
    run, ok = _run(spec)
    assert ok
    m, tr = spec["config"]["model"], spec["config"]["train"]
    ref = train.reference_run(m, tr, run["checked"]["W"], run["checked"]["steps"])
    readings = calibrate.train_planted(spec, run["checked"], ref, variant)
    limits = spec["limits"]
    assert any(readings[k] > limits[k] for k in readings if k in limits), readings


@pytest.mark.parametrize("name", SERVE)
def test_altered_answer_fails(name, monkeypatch):
    from cdlnet_tpu_torch.serve import Denoiser

    spec = bench_tiny.tiny(name)
    method = "denoise_video" if "video" in name else "denoise_image"
    served = getattr(Denoiser, method)

    def altered(self, *args, **kw):
        out = served(self, *args, **kw)
        out.flat[np.argmax(out)] += 1e-3  # one pixel, where it is produced
        return out

    monkeypatch.setattr(Denoiser, method, altered)
    assert not _run(spec)[1]


@pytest.mark.parametrize("name", TRAIN)
def test_unchanged_state_fails(name, monkeypatch):
    from cdlnet_tpu_torch.train.optim import ClippedAdam

    monkeypatch.setattr(ClippedAdam, "update", lambda self, params, grads, state: state)
    monkeypatch.setattr("cdlnet_tpu_torch.models.CDLNetVideo.project", lambda self: self)
    monkeypatch.setattr("cdlnet_tpu_torch.models.CDLNet.project", lambda self: self)
    run, ok = _run(bench_tiny.tiny(name))
    assert not ok
    assert run["readings"]["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_fails(name, monkeypatch):
    import cdlnet_tpu_torch.train.fit as fit

    def half_mse(pred, target):
        n = pred.shape[0] // 2
        return torch.mean((pred[:n] - target[:n]) ** 2)

    monkeypatch.setattr(fit, "mse_loss", half_mse)
    assert not _run(bench_tiny.tiny(name))[1]
