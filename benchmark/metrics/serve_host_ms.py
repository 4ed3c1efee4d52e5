"""serve_host_ms (serving): the mean over the window's requests of each
request's wall time less the device busy time inside it, in ms. The client
is closed-loop and every request ends in the copy of its result to the
host, so the device works only inside requests: the sum of those
differences is the summed wall time less the trace's busy time."""


def read(run: dict):
    tr = run.get("trace")
    if not tr or tr["busy_s"] <= 0 or not run.get("requests"):
        return None
    return 1e3 * (run["wall_sum_s"] - tr["busy_s"]) / run["requests"]
