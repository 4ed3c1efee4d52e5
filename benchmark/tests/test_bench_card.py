"""One short run of each cell on the card, through the command a check
runs (skips without a CUDA card): it exits 0 and prints a result whose
`correct` is true, with the cell's metrics and the device it ran on."""

import json
import os
import subprocess
import sys

import bench_tiny
import pytest
import torch


@pytest.mark.cuda
@pytest.mark.parametrize("name", bench_tiny.LISTED)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, os.path.join(bench_tiny.BENCH, "run.py"),
                        "--workload", name, "--seed", str(2**31 + 101), "--seconds", "2",
                        "--trace", str(trace)], capture_output=True, text=True,
                       cwd=bench_tiny.ROOT, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert result["metrics"]
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
