"""The program's own spans of a traced window (cdlnet_tpu_torch.utils's
recorder: trace_span records only while a torch.profiler session runs, and
the benchmark's runs one only around the window, so the spans are the
window's). Each record is (name, start_ns, end_ns, parent, root): parent
the index of the enclosing span (-1: none), root that of the outermost;
end_ns None for a span still open, which the readers leave out.

A program without the recorder has no spans, and one that dropped spans
past its cap has no whole window: recorded() is then empty, and the
readers built on it find nothing to read."""

from __future__ import annotations


def recorded() -> list:
    """The program's spans, as recorded (indices intact), or [] where it
    records none or dropped some."""
    from cdlnet_tpu_torch import utils

    read = getattr(utils, "recorded_spans", None)
    if read is None or getattr(utils, "spans_dropped", 0):
        return []
    return read()


def mean_ms(spans: list, name: str):
    """The mean milliseconds of the finished spans `name`; None where there
    is none."""
    ns = [s[2] - s[1] for s in spans if s[0] == name and s[2] is not None]
    return 1e-6 * sum(ns) / len(ns) if ns else None


def first_child_end_ms(spans: list, name: str, child: str):
    """The mean over the finished spans `name` of the milliseconds from the
    start of each to the end of its first `child` span; None where no span
    `name` holds a finished one."""
    first = {}
    for s in spans:
        if s[0] == child and s[3] >= 0 and s[3] not in first:
            first[s[3]] = s[2]
    gaps = [first[i] - s[1] for i, s in enumerate(spans)
            if s[0] == name and s[2] is not None and first.get(i) is not None]
    return 1e-6 * sum(gaps) / len(gaps) if gaps else None
