"""Device milliseconds per NFE of the kernels ``classify`` names convolution
(cuDNN), over the profiled stretch."""

from benchmark.arith import classify


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    us = sum(e - s for name, s, e in tr["kernels"] if classify(name) == "convolution")
    return us / 1e3 / tr["nfe"] if us else None
