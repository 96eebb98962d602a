"""The benchmark's yardstick arithmetic: peaks, a kernel call's operations and
bytes, its least time, kernel classes, device busy time, the percentile over
all requests and the rate over a window.

Copied from the program's tooling so that later changes to the program
cannot move it: ``PEAK_BYTES_PER_S``, ``PEAK_FLOPS`` and ``bound`` from
``chip_smoke.py``, the operations and bytes of ``gn_case`` and ``attn_case``
there, ``classify`` and ``busy_us`` from ``diffpir_tpu_torch/profile_nfe.py``.
"""

from __future__ import annotations

import math

__all__ = ["PEAK_BYTES_PER_S", "PEAK_FLOPS", "ELEMENT_BYTES", "gn_cost", "attn_cost",
           "bound_s", "classify", "busy_us", "percentile", "rate"]

# H100 SXM (NVIDIA data sheet, dense, at the 700 W limit): HBM bytes/s and
# FLOP/s by type (float32 on the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def gn_cost(shape, dtype: str, film: bool, silu: bool) -> tuple[float, float]:
    """(operations, bytes) of one GroupNorm(+FiLM)(+SiLU) call on a (B, H, W, C)
    activation: x read once and the output written once, the fp32 scale and
    bias and, with FiLM, the fp32 (B, C) scale and shift read once."""
    b, c = shape[0], shape[-1]
    n = math.prod(shape)
    nbytes = 2 * n * ELEMENT_BYTES[dtype] + (2 * c + (2 * b * c if film else 0)) * 4
    flops = n * (4 + (2 if film else 0) + (4 if silu else 0))
    return float(flops), float(nbytes)


def attn_cost(b: int, t: int, heads: int, ch: int, dtype: str) -> tuple[float, float]:
    """(operations, bytes) of one legacy-QKV attention call: Q.K^T and P.V,
    2 T^2 ch each a head; qkv read once and the output written once."""
    nbytes = 4 * b * t * heads * ch * ELEMENT_BYTES[dtype]
    return float(4 * b * heads * t * t * ch), float(nbytes)


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time of a call on the card: its bytes at the memory rate or
    its operations at the peak rate of their type, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# device kernel name -> class, first match wins
CLASSES = (("groupnorm", ("gn_stats", "gn_apply", "gn_partial", "group_norm", "GroupNorm")),
           ("attention", ("attn_bf16", "attn_f32", "attn_wide", "softmax", "fmha", "flash")),
           ("convolution", ("conv", "Conv", "implicit", "xmma_fprop", "dgrad", "wgrad",
                            "fprop")),
           ("matmul", ("gemm", "Gemm", "gemv", "nvjet", "sm90_xmma", "cutlass")))


def classify(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linear between the two
    nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(count: float, start_s: float, end_s: float) -> float:
    """Work completed per second over a window from ``start_s`` to ``end_s``."""
    if end_s <= start_s:
        raise ValueError("empty window")
    return count / (end_s - start_s)
