"""One run of one cell: parse the arguments, find the cell, check the card,
run the module of the cell's traffic kind, check the result, print it.

The last lines on standard error are each compared number beside its
limit; the last line on standard output is the result:
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}. With --trace 0 the metrics are the cell's end-to-end ones, with
--trace 1 its per-layer ones, each read by its reader in benchmark/metrics/
(cells.metric_reader; a reader that finds nothing returns None and its
metric is left out).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

from benchlib import cells
from benchlib.tracing import stamp

# top-level module names a run must not have loaded: the JAX stack and the
# JAX package the measured port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "cdlnet_tpu")
# the benchlib module that runs each traffic kind
KINDS = {"serve_video": "serve", "serve_image": "serve", "train_epochs": "train"}


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__)
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="inputs and weights come from it")
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: trace the window and report the per-layer metrics")
    return p.parse_args(argv)


def forbidden_modules(modules) -> list:
    """The names in `modules` whose top-level part (before the first dot) is
    one of FORBIDDEN, compared whole."""
    return sorted(n for n in modules if n.split(".", 1)[0] in FORBIDDEN)


def query_card():
    """nvidia-smi's name and power limit of the card, started in the
    background (it takes half a second); read it with card()."""
    try:
        return subprocess.Popen(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def card(query) -> str:
    """The first card's line of query_card(), once it has ended."""
    if query is None:
        return "unread"
    out, _ = query.communicate()
    return out.strip().splitlines()[0] if query.returncode == 0 and out.strip() else "unread"


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """A run of the cell on `device`, by its traffic kind's module."""
    import importlib

    module = importlib.import_module(f"benchlib.{KINDS[spec['traffic']['kind']]}")
    return module.run(spec, seed, seconds, trace, device, t0)


def checks(run: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for each number the cell's limits file
    compares; a reading that is missing or not a finite number (None in the
    result) fails. Readings the file does not name are not compared."""
    values = {k: run["readings"].get(k) for k in limits}
    return {k: {"value": v if v is not None and math.isfinite(v) else None, "limit": limits[k]}
            for k, v in values.items()}


def passed(checked: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checked.values())


def read_metrics(run: dict, metrics) -> dict:
    """{name: value} of each metric (an entry of BENCHMARK.json) by its
    reader; a reader that finds nothing to read leaves its metric out."""
    values = {}
    for m in metrics:
        v = cells.metric_reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = v
    return values


def main(argv, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    spec = cells.resolve(args.workload)
    query = query_card()
    import torch

    stamp(t0, "import torch")
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        card(query)
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card(query)}", file=sys.stderr)
    stamp(t0, "card")
    device = torch.device("cuda", 0)
    run = run_cell(spec, args.seed, args.seconds, bool(args.trace), device, t0)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    values = read_metrics(run, spec["per_layer"] if args.trace else spec["end_to_end"])
    checked = checks(run, spec["limits"])
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": int(run["memory_peak_bytes"])}
    result = {"correct": passed(checked), "attempted": run["attempted"],
              "failed": run["failed"],
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
              "device": device_info}
    if args.trace and run["trace"]:
        tr = run["trace"]
        device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    counts = {k: run[k] for k in ("requests", "frames", "steps", "launches") if k in run}
    if run.get("latencies_s"):
        import numpy as np

        counts["latency_ms"] = {f"p{q}": 1e3 * float(np.percentile(run["latencies_s"], q))
                                for q in (50, 90, 95, 99, 100)}
    print(f"counts: {json.dumps(counts)}", file=sys.stderr)
    others = {k: v for k, v in run["readings"].items() if k not in checked}
    if others:
        print(f"not compared: {json.dumps(others)}", file=sys.stderr)
    for name, c in checked.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["checks"] = checked
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
