"""The readers of the program's spans (benchlib/spans.py and the metrics
with source "program_span"): each on hand-made span lists, on a program
without the recorder, and on a tiny run of each cell with the recorder on."""

import math
import time

import bench_tiny
import pytest
import torch

from benchlib import cells, main as bench, spans

MS = 1_000_000

# (name, start_ns, end_ns, parent, root): two served clips, between them a
# request of another thread still open at the window's end
SERVED = [
    ("serve_request", 0, 10 * MS, -1, 0),
    ("serve_input", 1 * MS, 2 * MS, 0, 0),
    ("serve_forward", 2 * MS, 6 * MS, 0, 0),
    ("lista3d_operands", 2 * MS, 3 * MS, 2, 0),
    ("lista3d_loop", 3 * MS, 5 * MS, 2, 0),
    ("serve_fetch", 6 * MS, 8 * MS, 0, 0),
    ("serve_output", 8 * MS, 9 * MS, 0, 0),
    ("serve_request", 15 * MS, None, -1, 7),  # open
    ("serve_input", 15 * MS, None, 7, 7),  # open
    ("serve_request", 20 * MS, 30 * MS, -1, 9),
    ("serve_input", 20 * MS, 23 * MS, 9, 9),
    ("serve_forward", 23 * MS, 27 * MS, 9, 9),
    ("lista3d_operands", 23 * MS, 25 * MS, 11, 9),
    ("lista3d_loop", 25 * MS, 27 * MS, 11, 9),
    ("serve_fetch", 27 * MS, 29 * MS, 9, 9),
    ("serve_output", 29 * MS, 30 * MS, 9, 9),
]

# two epochs of two steps each, a span of another thread still open
# between them, and an epoch still open at the end
EPOCHS = [
    ("train_epoch_scan", 0, 10 * MS, -1, 0),
    ("other_thread", 0, None, -1, 1),  # open
    ("train_epoch_begin", 0, 1 * MS, 0, 0),
    ("train_epoch_step", 1 * MS, 3 * MS, 0, 0),
    ("train_epoch_step", 3 * MS, 4 * MS, 0, 0),
    ("train_epoch_losses", 4 * MS, 5 * MS, 0, 0),
    ("train_epoch_scan", 20 * MS, 30 * MS, -1, 6),
    ("train_epoch_begin", 20 * MS, 24 * MS, 6, 6),
    ("train_epoch_step", 24 * MS, 25 * MS, 6, 6),
    ("train_epoch_step", 25 * MS, 29 * MS, 6, 6),
    ("train_epoch_losses", 29 * MS, 30 * MS, 6, 6),
    ("train_epoch_scan", 40 * MS, None, -1, 11),  # open
    ("train_epoch_begin", 40 * MS, 41 * MS, 11, 11),
    ("train_epoch_step", 41 * MS, 50 * MS, 11, 11),
]


@pytest.fixture
def program_spans(monkeypatch):
    """Hand the readers a span list as if the program had recorded it."""
    def give(records):
        monkeypatch.setattr("cdlnet_tpu_torch.utils.recorded_spans", lambda: list(records))
    return give


def read(name):
    return cells.metric_reader(name)({})


def test_recorded_keeps_the_spans_as_recorded(program_spans):
    """Open spans stay in place, so parent and root still index the list."""
    program_spans(EPOCHS)
    assert spans.recorded() == EPOCHS


def test_recorded_is_empty_once_spans_were_dropped(program_spans, monkeypatch):
    """A window cut off at the recorder's cap is no window: every span
    metric is left out."""
    from cdlnet_tpu_torch import utils

    program_spans(SERVED)
    monkeypatch.setattr(utils, "spans_dropped", 1)
    assert spans.recorded() == []
    assert all(read(name) is None for name in _span_metrics())


@pytest.mark.parametrize("name,want", [
    ("serve_input_ms", (1 + 3) / 2),  # the open one left out
    ("serve_output_ms", (1 + 1) / 2),
    ("operands_ms", (1 + 2) / 2),
    ("loop_issue_ms", (2 + 2) / 2),
])
def test_serving_readers(program_spans, name, want):
    program_spans(SERVED)
    assert read(name) == pytest.approx(want)


@pytest.mark.parametrize("cell", ["train", "image_train"])
def test_epoch_readers(program_spans, cell):
    """Each finished epoch's start to its first step's end; the open epoch
    left out."""
    program_spans(EPOCHS)
    assert read(f"epoch_gap_ms.{cell}") == pytest.approx((3 + 5) / 2)


def test_first_child_end_keeps_to_the_indices_past_an_open_span():
    assert spans.first_child_end_ms(EPOCHS, "train_epoch_scan", "train_epoch_begin") \
        == pytest.approx((1 + 4) / 2)
    assert spans.first_child_end_ms(EPOCHS, "train_epoch_scan", "other_thread") is None


def _span_metrics():
    return [m["name"] for m in cells.load_spec()["per_layer"] if m["source"] == "program_span"]


@pytest.mark.parametrize("name", _span_metrics())
def test_readers_find_nothing_without_spans(program_spans, name):
    program_spans([])
    assert read(name) is None
    program_spans([("other", 0, MS, -1, 0)])
    assert read(name) is None


@pytest.mark.parametrize("name", _span_metrics())
def test_readers_find_nothing_in_a_program_without_the_recorder(monkeypatch, name):
    """The parent commit's program has no recorded_spans: its traced runs
    leave these metrics out and do not fail."""
    monkeypatch.delattr("cdlnet_tpu_torch.utils.recorded_spans")
    assert spans.recorded() == []
    assert read(name) is None


@pytest.mark.parametrize("name", bench_tiny.LISTED)
def test_tiny_run_under_a_profiler_reads_its_span_metrics(monkeypatch, name):
    """A tiny run of each cell with the program's recorder on (a CPU
    profile around the whole run): every span metric BENCHMARK.json lists
    for the cell reads a finite positive number."""
    from cdlnet_tpu_torch import utils

    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")
    spec = bench_tiny.tiny(name)
    spec["traffic"]["warmup_s"] = 0.0
    utils.clear_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            run = bench.run_cell(spec, 2**31 + 17, 0.2, False, torch.device("cpu"),
                                 time.perf_counter())
        wanted = [m for m in spec["per_layer"] if m["source"] == "program_span"]
        assert wanted
        values = bench.read_metrics(run, wanted)
    finally:
        utils.clear_spans()
    assert set(values) == {m["name"] for m in wanted}
    assert all(math.isfinite(v) and v > 0 for v in values.values()), values
