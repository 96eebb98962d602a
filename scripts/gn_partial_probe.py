#!/usr/bin/env python3
"""Times the sharded GroupNorm's partial-statistics launch on one CUDA card.

    python3 scripts/gn_partial_probe.py [--package-root DIR] [--stamps] [--sweep]
                                        [--plans SHAPE=PLAN;...] [--out FILE]

At each shape a ``space`` rank's shard gives the launch (DEMO256 bf16 b4 and
demo64 fp32 b4, half the rows: the shapes of ``chip_smoke.py``'s phase
kernels), with the port's package taken from ``--package-root`` (default:
this checkout; an unpacked older commit compares two versions in turns):

* device ms of the launch (20 calls in a CUDA graph, as ``chip_smoke.graph_ms``),
  its bound (one read of the tensor at 3.35 TB/s), the largest error against
  ``groupnorm_partial_stats_plain`` relative to each sum's size, and whether
  a rerun repeats bit for bit;
* ``--stamps``: a breakdown of one launch from the global timer, read by
  thread 0 of every block.  The package's ``groupnorm_partial.cu`` is built a
  second time with ``-DDIFFPIR_GN_STAMPS`` into a library of its own under
  ``.kernel_build/stamps/`` (a package without that file, whose partial
  statistics came from ``gn_stats``, is only timed).  Printed per shape:
  blocks, the span from the first block's start to the last block's end, the
  median block's loads and block reduction, the SMs used, and the graph time
  not covered by the span (launch and drain); ``--plans`` breaks down other
  plans "chunks x rows x segments" of a shape too;
* ``--sweep``: the device ms of plans (channel chunks 1, 2, 4 or 8, rows,
  pixel segments) at each shape, for this checkout's kernel, each held to the
  plain version and to a bit-equal rerun.

Prints one JSON object per line; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES_PER_S = 3.35e12
RTOL = 1e-4   # chip_smoke.PARTIAL_STATS_RTOL

_STAMP_API = r"""
extern "C" int diffpir_gn_stamps_clear() {
  void* p;
  cudaError_t e = cudaGetSymbolAddress(&p, g_stamps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(p, 0, sizeof(g_stamps));
}
extern "C" int diffpir_gn_stamps_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(unsigned long long) * n);
}
"""
STAMPS = 4   # a block's start, loads done, block reduced, and its SM's id


def shard_shapes(dev):
    """(shape, dtype) of each partial-statistics call of one forward on a
    space rank: DEMO256 bf16 b4 and demo64 fp32 b4, half the rows."""
    import torch

    from chip_smoke import record_kernel_calls
    from diffpir_tpu_torch.models import zoo
    from diffpir_tpu_torch.models.unet import UNet

    out = []
    t = torch.tensor([999, 500, 250, 10], dtype=torch.int32, device=dev)
    for cfg, hw, dtype in ((zoo.DEMO256_CONFIG, 256, torch.bfloat16),
                           (zoo.DEMO_HQ_CONFIG, 64, torch.float32)):
        model = zoo.init_random_(UNet(cfg, dtype=dtype, kernels="plain"), 0).to(dev).eval()
        calls = record_kernel_calls(model, torch.randn((4, hw, hw, 3), device=dev), t)
        for c in calls:
            if c[0] == "gn":
                b, h, w, ch = c[1]
                out.append(((b, h // 2, w, ch), dtype))
        del model
    return out


def build_stamped(build) -> ctypes.CDLL:
    """The package's partial-statistics source built with stamps."""
    csrc = build.CSRC
    out_dir = os.path.join(build.BUILD_DIR, "stamps")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(csrc, "groupnorm_partial.cu")) as f:
        src = f.read() + "\n#ifdef DIFFPIR_GN_STAMPS\n" + _STAMP_API + "#endif\n"
    path = os.path.join(out_dir, "stamped.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, "libstamped.so")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-DDIFFPIR_GN_STAMPS",
                    "-I", csrc, "-shared", "-o", lib, path], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(lib)


def plan_call(lib, x, g: int, plan):
    """A call of ``lib``'s ``diffpir_groupnorm_partial_stats`` on ``x`` with
    ``plan`` (chunks, rows, segments), on the current stream; returns the
    call and the (B, G, 3) tensor it writes."""
    import torch

    P, I = ctypes.c_void_p, ctypes.c_int
    b, h, w, c = x.shape
    out = torch.empty((b, g, 3), dtype=torch.float32, device=x.device)
    ws = torch.empty(2 * b * plan.segments * g, dtype=torch.float32, device=x.device)
    fn = lib.diffpir_groupnorm_partial_stats
    fn.argtypes = [P, P, P, I, I, I, I, I, I, I, I, P]

    def call():
        rc = fn(x.data_ptr(), out.data_ptr(), ws.data_ptr(), b, h * w, c, g, plan.chunks,
                plan.segments, plan.rows, int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"diffpir_groupnorm_partial_stats returned {rc}")

    return call, out


def stamped_call(lib, x, g: int, plan) -> np.ndarray:
    """One launch of the stamped library; returns the stamps (blocks,
    STAMPS) in ns (the last column the SM's id; 0 where a block did not reach
    a point)."""
    import torch

    call, _ = plan_call(lib, x, g, plan)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    assert lib.diffpir_gn_stamps_clear() == 0
    torch.cuda.synchronize()
    call()
    torch.cuda.synchronize()
    blocks = x.shape[0] * plan.chunks * plan.segments
    buf = (ctypes.c_ulonglong * (blocks * STAMPS))()
    assert lib.diffpir_gn_stamps_read(buf, blocks * STAMPS) == 0
    return np.frombuffer(buf, dtype=np.uint64).astype(np.int64).reshape(blocks, STAMPS)


def breakdown(st: np.ndarray) -> dict:
    """Microseconds of one launch from its stamps (see the module's text)."""
    sms = st[:, -1]
    st = st[:, :-1]
    start = st[:, 0]
    t0 = start.min()
    nz = np.diff(np.unique(st[st > 0]))
    return {"blocks": int(len(st)), "span_us": float(st.max() - t0) / 1e3,
            "start_skew_us": float(start.max() - t0) / 1e3,
            "loads_us": float(np.median(st[:, 1] - st[:, 0])) / 1e3,
            "reduce_us": float(np.median(st[:, 2] - st[:, 1])) / 1e3,
            "timer_step_ns": int(nz[nz > 0].min()) if (nz > 0).any() else 0,
            "sms": int(len(np.unique(sms))), "max_blocks_an_sm": int(np.bincount(sms).max())}


def sweep(lib, kgn, x, graph_ms) -> dict:
    """Device ms of each plan "chunks x rows x segments" (each checked
    against the plain version and for a bit-equal rerun; a plan that fails
    raises)."""
    import torch

    b, h, w, c = x.shape
    hw = h * w
    vec = 16 // x.element_size()
    ref = kgn.groupnorm_partial_stats_plain(x)
    out = {}
    for chunks in (1, 2, 4, 8):
        if c % chunks or 32 % chunks or (c // chunks) % vec:
            continue
        nv = c // chunks // vec
        for segments in (1, 2, 4, 8, 16, 32):
            per = -(-hw // segments)
            if segments > hw or segments * b * chunks > 528:
                continue
            for threads in (128, 256, 512):
                rows = max(1, min(threads // nv, per))
                plan = kgn.PartialPlan(chunks, rows, segments)
                key = "x".join(map(str, plan))
                if nv * rows > 512 or key in out:
                    continue
                call, got = plan_call(lib, x, 32, plan)
                call()
                first = got.clone()
                call()
                err = float(((first - ref).abs() / ref.abs().clamp_min(1.0)).max())
                if err > RTOL or not torch.equal(first, got):
                    raise AssertionError(f"plan {key} at {tuple(x.shape)}: err {err}")
                out[key] = graph_ms(call)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package-root", default=REPO)
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--plans", default=None, metavar="SHAPE=PLAN;...",
                    help="with --stamps, also break down these plans, e.g. "
                         "'4x128x256x96=2x42x32,8x85x1;4x64x128x96=4x85x1'")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gn_partial_probe: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, root)
    from diffpir_tpu_torch.kernels import build
    from diffpir_tpu_torch.kernels import groupnorm as kgn

    sys.path.insert(1, REPO)
    from chip_smoke import graph_ms, smi_line

    dev = torch.device("cuda")
    lib = build.load_library()
    ours = hasattr(kgn, "partial_plan")
    stamped = build_stamped(build) if args.stamps and ours else None
    lines = []

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        lines.append(line)

    emit({"package": root, "card": smi_line(), "torch": torch.__version__})
    gen = torch.Generator(device=dev).manual_seed(0)
    totals = {}
    plans = {}
    for item in (args.plans or "").split(";"):
        if item:
            key, _, values = item.partition("=")
            plans[key] = values.split(",")
    done = set()
    for shape, dtype in shard_shapes(dev):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        got, again = kgn.groupnorm_partial_stats(x), kgn.groupnorm_partial_stats(x)
        ref = kgn.groupnorm_partial_stats_plain(x)
        err = float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())
        ms = graph_ms(lambda: kgn.groupnorm_partial_stats(x))
        bound = (x.numel() * x.element_size() + shape[0] * 32 * 12) / PEAK_BYTES_PER_S * 1e3
        rec = {"shape": list(shape), "dtype": str(dtype).split(".")[1], "ms": ms,
               "bound_ms": bound, "err": err, "ok": err <= RTOL,
               "repeats": bool(torch.equal(got, again))}
        if ours:
            plan = kgn.partial_plan(shape[0], shape[1] * shape[2], shape[3],
                                    x.element_size())
            rec["plan"] = list(plan)
        if stamped is not None:
            rec.update(breakdown(stamped_call(stamped, x, 32, plan)))
            rec["launch_and_drain_us"] = ms * 1e3 - rec["span_us"]
            key = "x".join(map(str, shape))
            for text in (plans.get(key, []) if key not in done else []):
                other = kgn.PartialPlan(*(int(v) for v in text.split("x")))
                pr = breakdown(stamped_call(stamped, x, 32, other))
                pr["ms"] = graph_ms(plan_call(lib, x, 32, other)[0])
                rec.setdefault("plans", {})[text] = pr
            done.add(key)
        if args.sweep and ours:
            rec["sweep_ms"] = sweep(lib, kgn, x, graph_ms)
        key = f"{rec['dtype']} b{shape[0]}"
        totals.setdefault(key, {"calls": 0, "ms": 0.0, "bound_ms": 0.0})
        totals[key]["calls"] += 1
        totals[key]["ms"] += ms
        totals[key]["bound_ms"] += bound
        emit(rec)
        if not (rec["ok"] and rec["repeats"]):
            emit({"fail": rec["shape"]})
            return 1
    emit({"totals": totals})
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
