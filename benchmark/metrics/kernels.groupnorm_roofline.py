"""The port's GroupNorm kernels' share of their roofline over the profiled
stretch: the least time of every call (from each recorded call's shape,
each input and output byte counted once, ``arith.gn_cost``), over the
device time of the kernels named ``gn_stats``, ``gn_apply`` or
``gn_partial``, in %."""

KERNELS = ("gn_stats", "gn_apply", "gn_partial")


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    us = sum(e - s for name, s, e in tr["kernels"] if any(k in name for k in KERNELS))
    if not us:
        return None
    return 100.0 * record["bounds_per_forward"]["groupnorm"] * tr["nfe"] / (us / 1e6)
