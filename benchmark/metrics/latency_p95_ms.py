"""latency_p95_ms (end to end, serving cells): the 95th percentile of every
request of the window, each timed from the call to the numpy result it
returns, in ms."""

import numpy as np


def read(run: dict):
    lat = run.get("latencies_s")
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
