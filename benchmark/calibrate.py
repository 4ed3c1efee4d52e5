#!/usr/bin/env python3
"""The readings the correctness limits of a cell are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --first <seed> \
        [--control 3] [--seconds 1]

In one process, on the card: the program's sound runs on `--seeds` seeds
(first, first + 1, ...), each a whole run of the cell (set-up, a window
of --seconds, the check), and then on the first `--control` of those seeds
the control: the reference put in the program's place and computed in
TF32 (the precision below the configuration's float32), compared with the
float32 reference as the program is. For a training cell also the fault
"half of the batch left out, the mean taken over the rest", planted in
the reference put in the program's place. A state left unchanged reads 1
on change_gap and needs no run.

Prints one line a reading ("reading <what> <seed> {...}") and a summary:
the largest reading of the sound runs (the lower reading of each limit)
and the smallest of the control and of the fault (upper readings).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_extensions")
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def serve_control(spec, seed, device) -> dict:
    from benchlib import serve

    inputs = serve.make_pool(spec["traffic"], seed, device)
    inputs = inputs[: spec["traffic"]["check_requests"]]
    exact = serve.reference_outputs(spec["config"], spec["traffic"], seed, inputs, device)
    tf32 = serve.reference_outputs(spec["config"], spec["traffic"], seed, inputs, device,
                                   exact=False)
    return {"max_abs_err": max(float(abs(a - b).max()) for a, b in zip(tf32, exact))}


def train_planted(spec, checked, exact_ref, variant) -> dict:
    """Readings of the reference in the program's place: in TF32
    ("control"), or on the first half of each batch ("half_batch")."""
    from benchlib import train

    m, tr = spec["config"]["model"], spec["config"]["train"]
    W, steps = checked["W"], checked["steps"]
    if variant == "control":
        got = train.reference_run(m, tr, W, steps, exact=False)
    else:
        half = [{k: (v[: v.shape[0] // 2] if k in ("noisy", "sigma", "clean") else v)
                 for k, v in r.items()} for r in steps]
        got = train.reference_run(m, tr, W, half)
    return train.compare(m, tr, W, steps, got["losses"], got["grad0"], got["params"],
                         ref=exact_ref)


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    a = p.parse_args(argv)

    import torch

    from benchlib import cells, main as bench, train

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    spec = cells.resolve(a.workload)
    device = torch.device("cuda", 0)
    sound, planted = [], {}
    for i in range(a.seeds):
        seed = a.first + i
        run = bench.run_cell(spec, seed, a.seconds, False, device, time.perf_counter())
        sound.append(run["readings"])
        print(f"reading sound {seed} {json.dumps(run['readings'])}", flush=True)
        if i >= a.control:
            continue
        if run["kind"] == "serve":
            planted.setdefault("control", []).append(serve_control(spec, seed, device))
        else:
            m, tr = spec["config"]["model"], spec["config"]["train"]
            ref = train.reference_run(m, tr, run["checked"]["W"], run["checked"]["steps"])
            for variant in ("control", "half_batch"):
                planted.setdefault(variant, []).append(
                    train_planted(spec, run["checked"], ref, variant))
        for variant, rs in planted.items():
            print(f"reading {variant} {seed} {json.dumps(rs[-1])}", flush=True)
        del run
        torch.cuda.empty_cache()
    summary = {"sound_max": {k: max(r[k] for r in sound) for k in sound[0]}}
    for variant, rs in planted.items():
        summary[f"{variant}_min"] = {k: min(r[k] for r in rs) for k in rs[0]}
    print("summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
