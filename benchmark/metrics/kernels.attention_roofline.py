"""The port's attention kernels' share of their roofline over the profiled
stretch: the least time of every call (``arith.attn_cost``: Q.K^T and P.V,
qkv read and the output written once), over the device time of the kernels
named ``attn_bf16``, ``attn_f32`` or ``attn_wide``, in %."""

KERNELS = ("attn_bf16", "attn_f32", "attn_wide")


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    us = sum(e - s for name, s, e in tr["kernels"] if any(k in name for k in KERNELS))
    if not us:
        return None
    return 100.0 * record["bounds_per_forward"]["attention"] * tr["nfe"] / (us / 1e6)
