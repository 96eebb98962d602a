"""Images completed over the whole window, per second of it: the window runs
from the first request's start to the fetch of the last one it started."""

from benchmark.arith import rate


def read(record):
    w = record["window"]
    return rate(w["images"], w["start"], w["end"]) if w["images"] else None
