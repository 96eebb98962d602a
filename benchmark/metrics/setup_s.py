"""Seconds from the process's start to the first timed request: imports, the
kernel library, the port's Runner with the seed's weights, the warm-up."""


def read(record):
    return record["setup_s"]
