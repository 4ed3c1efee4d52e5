#!/usr/bin/env python3
"""The benchmark of cdlnet_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
It loads the cell's configuration and traffic (BENCHMARK.json names them),
makes its inputs and weights on the card from the seed, warms up, measures
for the given seconds, checks what the timed path produced against the
plain reference (benchmark/reference/), and prints one JSON line. Without a
CUDA card it exits with code 2 and prints no result.

Build and kernel caches stay inside the checkout: the port's kernel
library in cdlnet_tpu_torch/kernels/_build/, Triton's and torch's
extension caches under benchmark/.cache/.
"""

import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_extensions")
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from benchlib.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=T0))
