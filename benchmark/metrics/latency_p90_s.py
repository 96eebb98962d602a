"""The 90th percentile, over every request of the window, of the seconds from
making the request to its result fetched to the host."""

from benchmark.arith import percentile


def read(record):
    lat = record["window"]["latencies"]
    return percentile(lat, 90.0) if lat else None
