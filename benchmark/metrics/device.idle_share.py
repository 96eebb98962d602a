"""The share of the untraced window in which no operation ran on the card,
in %: 1 - (the card's busy time per request) / (the window's seconds per
request).  The busy time is the union of the device's intervals over the
profiled stretch, per request: the profiler slows the host's dispatch, not
the card's kernels, so the stretch's own wall time would overstate the
idle share where the host paces the card."""

from benchmark.arith import busy_us


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    s0, s1 = tr["stretch_us"]
    busy = busy_us((max(a, s0), min(b, s1)) for _, a, b in tr["kernels"] if b > s0 and a < s1)
    w = record["window"]
    period_us = 1e6 * (w["end"] - w["start"]) / w["requests"]
    return 100.0 * (1.0 - busy / tr["requests"] / period_us)
