"""mfu.<cells> (the whole request or step): the model operations of the
window's work (work.py) over the window's seconds times the dense TF32
peak, in %."""

import work


def read(run: dict):
    if not run["flops"]:
        return None
    return 100.0 * run["flops"] / (run["window_s"] * work.TF32_PEAK_FLOPS)
