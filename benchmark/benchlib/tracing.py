"""The device trace of a measured window, read in memory.

torch.profiler records the card's kernels, copies and fills and the
host's CUDA runtime calls (its CUDA activity only: recording every host
operator as well slowed a traced serving window by ~12%); nothing is
written to disk. The kineto events' times are nanoseconds on the same
clock as time.time_ns(), so the window the host measured clips them.

From the device events within the window:
  busy_s     the union of the intervals in which a kernel, copy or fill ran
  kernel_s   the kernels' summed durations (copies and fills left out)
  device_ops the ten names that took the most device time, [name, s]
  idle_gaps  the ten longest gaps between device work, each named by the
             shortest host event running at its middle (a runtime call, or
             "host code" where the host ran no CUDA call), [name, s]
"""

from __future__ import annotations

import sys
import time

NAME_CHARS = 160


class Trace:
    """with Trace(on) as tr: ... ; then tr.summary(t0_ns, t1_ns). With on
    False it records nothing and summary() is None."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def summary(self, t0_ns: int, t1_ns: int):
        if self.prof is None:
            return None
        from torch.autograd import DeviceType

        dev, host = [], []
        for ev in self.prof.profiler.kineto_results.events():
            a, b = ev.start_ns(), ev.start_ns() + ev.duration_ns()
            if b <= t0_ns or a >= t1_ns:
                continue
            a, b = max(a, t0_ns), min(b, t1_ns)
            if ev.device_type() == DeviceType.CUDA:
                if not ev.is_user_annotation():  # spans mirrored onto the device
                    dev.append((a, b, ev.name()))
            elif ev.device_type() == DeviceType.CPU:
                host.append((a, b, ev.name()))
        return summarize(dev, host, t0_ns, t1_ns)


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def summarize(dev, host, t0_ns: int, t1_ns: int) -> dict:
    """dev, host: (start_ns, end_ns, name) within [t0_ns, t1_ns]."""
    dev = sorted(dev)
    busy, gaps = 0, []
    cur_a = cur_b = None
    last_end = t0_ns
    for a, b, _ in dev:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            if a > last_end:
                gaps.append((a - last_end, last_end, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        last_end = max(last_end, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    if t1_ns > last_end:
        gaps.append((t1_ns - last_end, last_end, t1_ns))
    by_name = {}
    kernel_ns = 0
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0) + (b - a)
        if _is_kernel(name):
            kernel_ns += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps, reverse=True)[:10]
    idle = [[_host_at(host, (a + b) // 2), g / 1e9] for g, a, b in longest]
    return {
        "window_s": (t1_ns - t0_ns) / 1e9,
        "busy_s": busy / 1e9,
        "kernel_s": kernel_ns / 1e9,
        "device_ops": [[n[:NAME_CHARS], v / 1e9] for n, v in ops],
        "idle_gaps": idle,
    }


def _host_at(host, t: int) -> str:
    """The shortest host event that covers time t: what the host was doing."""
    best = None
    for a, b, name in host:
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return "host code" if best is None else best[1][:NAME_CHARS]


def stamp(t0: float, what: str) -> None:
    """A set-up step's end, in seconds since the process started, on
    standard error."""
    print(f"setup: {what} at {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
