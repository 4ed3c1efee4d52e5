"""Shared by the benchmark's tests: its folders on sys.path, and a cell cut
to a size the CPU runs in a second (every width and shape shrunk; the
traffic's kind, the checks and the limits as the cell has them)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import cells  # noqa: E402

# the cells of BENCHMARK.json, and those whose files and traffic kind are
# kept for a later PR to list again (PERF.md's open questions)
KEPT = {"image-serve-481x321-blind": {"name": "image-serve-481x321-blind",
                                      "config": "cdlnet-s2030", "chips": 1,
                                      "traffic": "serve-image-481x321-blind"}}
LISTED = [c["name"] for c in cells.load_spec()["workloads"]]
CELLS = LISTED + list(KEPT)


def spec_of(name: str) -> dict:
    return cells.resolve(name, cell=KEPT.get(name))


def tiny(name: str) -> dict:
    spec = spec_of(name)
    c, t = spec["config"], spec["traffic"]
    if c["type"] == "CDLNetVideo":
        c["model"].update(K=3, M=6, P=[3, 3, 3], depth=4)
        c["train"].update(batch=2, crop=8, depth=4)
        c["corpus"].update(videos=6, height=20, width=24)
        c["frames_per_video"] = 7
    else:
        c["model"].update(K=3, M=6, P=5)
        c["train"].update(batch=3, crop=12)
        c["corpus"].update(images=12, height=21, width=31)
    if "shape" in t:
        t.update(shape=[4, 16, 16] if t["kind"] == "serve_video" else [21, 31],
                 pool=6, check_requests=3, bucket=8, warmup_s=0.05)
    return spec
