"""kernel_roofline.<cells> (kernels): the roofline time of the window's work
(work.py: operations over the TF32 peak or compulsory bytes over the memory
bandwidth, whichever is longer) over the device kernels' summed time in the
trace, in %."""


def read(run: dict):
    tr = run.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["kernel_s"] <= 0 or not run["roofline_s"]:
        return None
    return 100.0 * run["roofline_s"] / tr["kernel_s"]
