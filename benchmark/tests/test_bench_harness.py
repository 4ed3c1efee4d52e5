"""The harness on the CPU: its arguments, the cells found by name from
their files, BENCHMARK.json's form, a run without a card, the import
check, the trace reduction and a whole run of each cell at a tiny size."""

import json
import os
import re
import subprocess
import sys
import time

import bench_tiny
import pytest
import torch

from benchlib import cells, main as bench, tracing

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(autouse=True)
def fp32_histories(monkeypatch):
    """The program's training histories in float32 here: at these tiny
    widths the default bf16 copies move a step's gradients by more (a
    change_gap of ~2e-5) than at the cells' own widths on the card, where
    the limits were set (~2e-6); the check's logic is what these runs
    hold."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")


def test_parse_arguments():
    a = bench.parse(["--workload", "video-serve-16x128", "--seed", str(2**31 + 5),
                     "--seconds", "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("video-serve-16x128", 2**31 + 5, 10.0, 1)
    assert bench.parse(["--workload", "x", "--seed", "1", "--seconds", "2"]).trace == 0
    with pytest.raises(SystemExit):
        bench.parse(["--workload", "x", "--seed", "1", "--seconds", "2", "--trace", "2"])
    with pytest.raises(SystemExit):
        bench.parse(["--seed", "1", "--seconds", "2"])


@pytest.mark.parametrize("name", bench_tiny.LISTED)
def test_cell_found_by_name(name):
    spec = cells.resolve(name)
    assert spec["cell"]["name"] == name
    assert spec["traffic"]["kind"] in bench.KINDS
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(cells.metric_reader(m["name"]))
    for m in spec["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_metrics_read_by_their_quantity():
    spec = cells.load_spec()
    quantities = {m["name"].split(".", 1)[0] for m in spec["end_to_end"] + spec["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(bench_tiny.BENCH, "metrics"))
             if f.endswith(".py")}
    assert quantities == files
    assert cells.metric_reader("mfu.train") is not None
    run = {"flops": 495e12, "window_s": 2.0}
    assert cells.metric_reader("mfu.image_train")(run) == pytest.approx(50.0)


def test_unknown_cell():
    with pytest.raises(KeyError):
        cells.resolve("no-such-cell")


def test_benchmark_json_form():
    spec = cells.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]] \
        + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(cells.ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(cells.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    texts = [c["source"] for c in spec["configs"]] + [c["why"] for c in spec["configs"]] \
        + [m["layer"] for m in spec["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert len(json.dumps(spec)) < 64 * 1024


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(bench_tiny.BENCH, "run.py"),
                        "--workload", "video-serve-16x128", "--seed", "7", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["cdlnet_tpu_torch", "cdlnet_tpu_torch.serve", "cdlnet_tpu", "cdlnet_tpu.ops",
            "jax", "jaxlib.xla_client", "jax_like", "flax.linen", "flaxen", "numpy"]
    assert bench.forbidden_modules(mods) == ["cdlnet_tpu", "cdlnet_tpu.ops", "flax.linen",
                                             "jax", "jaxlib.xla_client"]


def test_harness_and_reference_import_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]\n"
            "import benchlib.main, benchlib.serve, benchlib.train, benchlib.synth, calibrate\n"
            "import reference.lista, reference.mad, reference.train, reference.corpus\n"
            "top = {{n.split('.')[0] for n in sys.modules}}\n"
            "print(sorted(top & {{'jax', 'jaxlib', 'flax', 'cdlnet_tpu', 'cdlnet_tpu_torch'}}))"
            ).format(bench_tiny.BENCH, bench_tiny.ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_trace_summary():
    ms = 1_000_000
    dev = [(1 * ms, 3 * ms, "k1"), (2 * ms, 4 * ms, "k2"), (6 * ms, 7 * ms, "Memcpy HtoD"),
           (9 * ms, 10 * ms, "k1")]
    host = [(0, 10 * ms, "cudaStreamSynchronize"), (4 * ms, 6 * ms, "cudaMemcpyAsync")]
    s = tracing.summarize(dev, host, 0, 12 * ms)
    assert s["window_s"] == pytest.approx(0.012)
    assert s["busy_s"] == pytest.approx(0.005)       # [1, 4] + [6, 7] + [9, 10]
    assert s["kernel_s"] == pytest.approx(0.005)     # 2 + 2 + 1, the copy left out
    assert s["device_ops"][0] == ["k1", pytest.approx(0.003)]
    # gaps [10, 12], [7, 9], [4, 6], [0, 1] ms, each named by the shortest
    # host event at its middle
    assert s["idle_gaps"] == [["host code", pytest.approx(0.002)],
                              ["cudaStreamSynchronize", pytest.approx(0.002)],
                              ["cudaMemcpyAsync", pytest.approx(0.002)],
                              ["cudaStreamSynchronize", pytest.approx(0.001)]]


@pytest.mark.parametrize("name", bench_tiny.CELLS)
def test_tiny_run_is_correct(name):
    spec = bench_tiny.tiny(name)
    run = bench.run_cell(spec, 2**31 + 11, 0.3, False, torch.device("cpu"), time.perf_counter())
    checked = bench.checks(run, spec["limits"])
    assert bench.passed(checked), checked
    assert run["attempted"] > 0 and run["failed"] == 0
    values = bench.read_metrics(run, spec["end_to_end"])
    assert set(values) == {m["name"] for m in spec["end_to_end"]}
    # the CPU has no allocator peak to read
    assert all(v > 0 for k, v in values.items() if k != "train_peak_mem_gb")
    # the per-layer readers find nothing to read without a trace, except the
    # counts and the model's share, which need none
    for v in bench.read_metrics(run, spec["per_layer"]).values():
        assert v >= 0
