"""Find a cell and everything that belongs to it by name.

BENCHMARK.json at the checkout's root lists the configurations, cells
("workloads") and metrics. A cell's configuration is the JSON file its
entry names; its traffic mix is benchmark/traffic/<traffic>.json; the
limits of its correctness check are benchmark/limits/<cell>.json; each
metric, end-to-end or per-layer, is read by benchmark/metrics/<quantity>.py,
the quantity being its name up to the first dot (mfu.train and
mfu.image_train share mfu.py; a cell group whose spread needs a bound of its
own reports under such a name). A new cell or metric is new files and new
entries: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT, cell: dict | None = None) -> dict:
    """The cell `name`: {"cell", "config", "traffic", "limits", "end_to_end",
    "per_layer", "run_seconds"}. Raises KeyError for a name BENCHMARK.json
    does not have, unless `cell` gives the entry ({"name", "config",
    "traffic", "chips"}) of a cell it does not list."""
    spec = load_spec(root)
    if cell is None:
        cells = {c["name"]: c for c in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {sorted(cells)})")
        cell = cells[name]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    bench = root / "benchmark"
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(bench / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    with open(bench / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return {
        "cell": cell, "config": config, "traffic": traffic, "limits": limits,
        "end_to_end": [m for m in spec["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in spec["per_layer"] if _applies(m, name)],
        "run_seconds": spec["run_seconds"],
    }


def metric_reader(name: str, bench: Path = BENCH):
    """The read(run) function of the metric `name`: that of
    benchmark/metrics/<quantity>.py, the quantity being the name up to its
    first dot. It returns None where the run holds nothing to read."""
    quantity = name.split(".", 1)[0]
    path = bench / "metrics" / f"{quantity}.py"
    mod_spec = importlib.util.spec_from_file_location("bench_metric_" + quantity, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
