"""The whole step's share of the card's bf16 peak: the UNet's FLOPs per image
and forward (counted from shapes, ``benchmark/flops.py``) times the forwards
of every image completed in the untraced window, over its wall time and over
989 TFLOP/s, in %."""

from benchmark.arith import PEAK_FLOPS


def read(record):
    w = record["window"]
    if not w["images"]:
        return None
    flops = record["flops_per_image_forward"] * record["nfe"] * w["images"]
    return 100.0 * flops / (w["end"] - w["start"]) / PEAK_FLOPS["bfloat16"]
