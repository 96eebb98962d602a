"""The benchmark's metric arithmetic, on the CPU."""

import math

import pytest
import torch

from benchmark import arith
from benchmark.flops import unet_flops


def test_bound_takes_the_slower_of_bytes_and_operations():
    # a GroupNorm+FiLM+SiLU over (16, 256, 256, 128) bf16: bytes bound it
    flops, nbytes = arith.gn_cost((16, 256, 256, 128), "bfloat16", True, True)
    n = 16 * 256 * 256 * 128
    assert flops == n * 10
    assert nbytes == 2 * n * 2 + (2 * 128 + 2 * 16 * 128) * 4
    assert arith.bound_s(flops, nbytes, "bfloat16") == nbytes / arith.PEAK_BYTES_PER_S
    # attention at T = 1024, 4 heads of 64: operations bound it in bf16
    flops, nbytes = arith.attn_cost(8, 1024, 4, 64, "bfloat16")
    assert flops == 4 * 8 * 4 * 1024 * 1024 * 64
    assert nbytes == 4 * 8 * 1024 * 4 * 64 * 2
    assert arith.bound_s(flops, nbytes, "bfloat16") == flops / 989e12
    assert arith.bound_s(1e9, 1.0, "float32") == 1e9 / 67e12


@pytest.mark.parametrize("name, cls", [
    ("void gn_stats<__nv_bfloat16>(...)", "groupnorm"),
    ("void gn_apply<float>(...)", "groupnorm"),
    ("void gn_partial<__nv_bfloat16, 4>(...)", "groupnorm"),
    ("attn_bf16_any<2>", "attention"),
    ("attn_f32_any_merge", "attention"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "convolution"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other"),
    ("regular_fft_factor", "other"),
])
def test_classify(name, cls):
    assert arith.classify(name) == cls


def test_busy_is_the_union_of_intervals():
    assert arith.busy_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert arith.busy_us([]) == 0


def test_percentile_over_every_request_and_rate_over_the_window():
    vals = [float(v) for v in range(1, 101)]
    assert arith.percentile(vals, 90) == pytest.approx(90.1)
    assert arith.percentile([3.0], 90) == 3.0
    assert arith.percentile(vals, 50) == pytest.approx(50.5)
    assert arith.rate(64, 10.0, 18.0) == 8.0
    with pytest.raises(ValueError):
        arith.rate(1, 5.0, 5.0)


@pytest.mark.parametrize("config, zoo_name, gflop", [
    ("ffhq256", "diffusion_ffhq_10m", 387.9),
    ("imagenet256", "256x256_diffusion_uncond", 2239.7),
])
def test_flops_per_forward_match_flop_counter_mode(config, zoo_name, gflop, data_root):
    """The benchmark's count from shapes equals ``FlopCounterMode`` over the
    port's plain route, both on the meta device (nothing is computed)."""
    import json

    from torch.utils.flop_counter import FlopCounterMode

    from diffpir_tpu_torch.models.unet import UNet
    from diffpir_tpu_torch.models.zoo import MODEL_ZOO_CONFIGS

    with open(f"{data_root}/benchmark/configs/{config}.json") as f:
        cfg = json.load(f)
    ours = unet_flops(cfg)
    with torch.device("meta"):
        model = UNet(MODEL_ZOO_CONFIGS[zoo_name], kernels="plain")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.empty((1, 256, 256, 3), device="meta"),
              torch.zeros((1,), dtype=torch.int32, device="meta"))
    assert ours == counter.get_total_flops()
    assert math.isclose(ours / 1e9, gflop, abs_tol=0.05)
