"""Where the time of one DiffPIR step (NFE) goes on the card.

    python -m diffpir_tpu_torch.profile_nfe [--kernels cuda|plain]

Runs a 20-NFE inpainting trajectory on the DEMO256 topology (bf16, batch 4,
256 px, seeded random weights, random image and 50 % mask) once to warm up,
then once without and once under ``torch.profiler``, and prints, per NFE:
the host wall time of both runs; from the profiled run's trace, the device
time by kernel class (GroupNorm, attention, convolution, matmul, other;
kernels that overlap each count in full) and the device's busy time, the
union of all its activity intervals, with its share of that same run's wall
time.  The rest of that wall time the card waits on the host's Python loop
and kernel dispatch.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch

from diffpir_tpu_torch import resolve_device, sampler
from diffpir_tpu_torch.models import zoo
from diffpir_tpu_torch.models.unet import UNet
from diffpir_tpu_torch.schedule import NoiseSchedule, build_plan

STEPS = 20   # NFE of the trajectory
BATCH = 4

# device kernel name -> class, first match wins
CLASSES = (("groupnorm", ("gn_stats", "gn_apply", "group_norm", "GroupNorm")),
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", choices=("cuda", "plain"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(cpu=False)
    from torch.profiler import ProfilerActivity, profile

    model = zoo.init_random_(UNet(zoo.DEMO256_CONFIG, dtype=torch.bfloat16,
                                  kernels=args.kernels), 0).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (BATCH, 256, 256, 3)
    y = torch.rand(shape, generator=gen, device=dev)
    mask = (torch.rand(shape[:3] + (1,), generator=gen, device=dev) < 0.5).float()
    sched = NoiseSchedule.linear(0.1 / 1000, 20 / 1000, 1000)
    plan = build_plan(sched, iter_num=STEPS + 1, lambda_=7.0, sigma_y=0.0)
    den = sampler.make_denoiser(model, sched, compute_dtype=torch.bfloat16)
    n_fwd = plan.n_steps - 1

    def trajectory():
        noise = sampler.generator_noise(gen, dev)
        x = sampler.init_x("inpaint", y, mask, 1, noise(-1, 0, "init", shape),
                           sqrt_acp_start=float(sched.sqrt_alphas_cumprod[-1]),
                           sqrt_1m_acp_start=float(np.sqrt(1 - sched.alphas_cumprod[-1])))
        return sampler.diffpir_sample(den, sampler.make_inpaint_prox(y, mask), plan, x,
                                      noise=noise, y=y, mask=mask, recover_known=True)

    trajectory()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trajectory()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trajectory()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    device_us = collections.Counter()
    for ev in prof.key_averages():
        if ev.device_type == cuda:
            device_us[classify(ev.key)] += ev.self_device_time_total
    busy = busy_us((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == cuda) / 1e3 / n_fwd
    if not device_us or not busy:
        raise RuntimeError("the profiler recorded no device time")
    result = {"topology": "DEMO256", "dtype": "bfloat16", "batch": BATCH,
              "kernels": args.kernels, "nfe": n_fwd, "device": torch.cuda.get_device_name(0),
              "wall_ms_per_nfe": wall_ms / n_fwd,
              "unprofiled_wall_ms_per_nfe": unprofiled_ms / n_fwd,
              "device_ms_per_nfe": {k: v / 1e3 / n_fwd for k, v in device_us.items()},
              "device_busy_ms_per_nfe": busy,
              "device_busy_share": busy / (wall_ms / n_fwd)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
