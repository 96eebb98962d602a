"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
limits and metrics are found by name from ``BENCHMARK.json``.  The run:
set-up (imports, the kernel library from ``.kernel_build/``, the port's
``Runner`` with the seed's weights, a two-step warm-up), the measured
window, the reading of the metrics, then the correctness check against the
plain reference once the program's state is freed.  The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown`` and
``trace_overhead`` (seconds per request of the stretch untraced and traced,
and of the window), and last ``compared``: each number compared beside its limit, which also end
standard error).  A run without a CUDA card, with fewer cards than the
cell asks for, or whose process holds JAX or the JAX package once the
window has closed, exits non-zero and prints no result.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """Seconds on the boot clock at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.clock_gettime(time.CLOCK_BOOTTIME)


_START = _process_start()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache a run writes stays in fixed directories of the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(_ROOT, ".bench_cache", _sub)

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "diffpir_tpu")
BREAKDOWN_ENTRIES = 10


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def since_start() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME) - _START


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""


def breakdown(trace: dict) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the stretch by the benchmark span open on the host."""
    per_name: dict = {}
    for name, start, end in trace["kernels"]:
        per_name[name] = per_name.get(name, 0.0) + (end - start) / 1e6
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    s0, s1 = trace["stretch_us"]
    merged = []
    for start, end in sorted((max(a, s0), min(b, s1)) for _, a, b in trace["kernels"]
                             if b > s0 and a < s1):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    edges = [s0] + [v for iv in merged for v in iv] + [s1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]

    def open_span(t):
        inside = [(b - a, n) for n, a, b in trace["spans"] if a <= t < b]
        return min(inside)[1] if inside else "bench.stretch"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[open_span(a), (b - a) / 1e6] for a, b in gaps[:BREAKDOWN_ENTRIES]]}


def run(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object.
    The card checks are ``main``'s: tests drive this on the CPU."""
    import gc

    import torch

    from benchmark import arith, drive, judge
    from benchmark.manifest import metric_reader

    is_cuda = torch.device(device).type == "cuda"
    prog = drive.Program(cell.config, cell.traffic, seed, device)
    record = {"nfe": prog.nfe, "batch": cell.traffic["batch"],
              "flops_per_image_forward": prog.flops_per_image,
              "bounds_per_forward": drive.kernel_bounds(prog.calls)}
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    record["setup_s"] = since_start()
    win = prog.window(seconds)
    outputs = win.pop("outputs")
    record["window"] = win
    record["peak_bytes"] = torch.cuda.max_memory_allocated() if is_cuda else 0
    t_window = since_start()
    finished = sorted(outputs)
    if trace:
        plain, plain_s = prog.untraced_stretch(win["requests"])
        outputs.update(plain["outputs"])
        stretch, record["trace"] = prog.traced_stretch(win["requests"] + plain["requests"])
        outputs.update(stretch["outputs"])
        s0, s1 = record["trace"]["stretch_us"]
        record["trace_overhead"] = {
            "untraced_s_per_request": plain_s / plain["requests"],
            "traced_s_per_request": (s1 - s0) / 1e6 / stretch["requests"],
            "window_s_per_request": (win["end"] - win["start"]) / win["requests"]}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the process holds {found} once the window has closed")
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = sum(o.shape[0] for o in outputs.values())
    # the program's state goes before the reference runs
    del prog
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    t_ref = since_start()
    sample = judge.draw_sample(cell.traffic, seed, finished)
    ref = judge.Reference(cell.config, seed, device)
    expected = judge.reference_outputs(ref, cell.traffic, seed, sample)
    numbers = judge.compare(outputs, sample, expected)
    correct, compared = judge.verdict(numbers, cell.limits["limits"])
    result = {"correct": correct, "attempted": attempted,
              "failed": int(numbers["nonfinite"]), "metrics": metrics,
              "device": {"platform": "gpu" if is_cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
                         "count": 1, "memory_peak_bytes": record["peak_bytes"]},
              "sample": [[r, rows] for r, rows in sample]}
    if trace:
        s0, s1 = record["trace"]["stretch_us"]
        result["device"]["busy_s"] = arith.busy_us(
            (max(a, s0), min(b, s1)) for _, a, b in record["trace"]["kernels"]
            if b > s0 and a < s1) / 1e6
        result["device"]["window_s"] = (s1 - s0) / 1e6
        result["breakdown"] = breakdown(record["trace"])
        result["trace_overhead"] = record["trace_overhead"]
    result["seconds"] = {"setup": record["setup_s"],
                         "window": win["end"] - win["start"],
                         "trace": t_ref - t_window, "reference": since_start() - t_ref}
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.manifest import Cell, load

    cell = Cell(load(_ROOT), args.workload, _ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"the cell needs {cell.entry['chips']} cards, "
              f"{torch.cuda.device_count()} are present", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    result["device"]["power_limit"] = power_limit()
    found = forbidden_modules()
    if found:
        print(f"the process holds {found}: the benchmark imports neither JAX nor "
              "the JAX package", file=sys.stderr)
        return 3
    for name, v in result["compared"].items():
        print(f"compared {name}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
