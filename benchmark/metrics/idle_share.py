"""idle_share.<cells> (device): the share of the traced window in which no
kernel, copy or fill ran on the device, in %."""


def read(run: dict):
    tr = run.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
