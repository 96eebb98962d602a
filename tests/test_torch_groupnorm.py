"""The port's GroupNorm+FiLM+SiLU against the JAX package: GroupNorm32's XLA
path and the Pallas kernel in interpret mode.  On the CPU the wrapper runs the
plain version; the CUDA kernel is held against it on the card by
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffpir_tpu.models.unet import GroupNorm32
from diffpir_tpu.pallas.groupnorm import groupnorm_silu as pallas_groupnorm_silu
from diffpir_tpu_torch.kernels import LAUNCHES
from diffpir_tpu_torch.kernels import groupnorm as tgn

# fp32: the tolerance of tests/test_pallas_groupnorm.py; bf16: one bf16 ulp
# at |y| ~ 4 plus the two frameworks' different rounding points
ATOL = {np.float32: 2e-5, "bfloat16": 3e-2}


def _inputs(seed, shape, film):
    rng = np.random.default_rng(seed)
    b, c = shape[0], shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    fs = fb = None
    if film:
        fs = (0.5 * rng.standard_normal((b, c))).astype(np.float32)
        fb = (0.5 * rng.standard_normal((b, c))).astype(np.float32)
    return x, scale, bias, fs, fb


def _xla(x, scale, bias, fs, fb, do_silu, dtype=jnp.float32):
    film = None if fs is None else (jnp.asarray(fs), jnp.asarray(fb))
    out = GroupNorm32(fuse_silu=do_silu).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(x, dtype), film=film)
    return np.asarray(out.astype(jnp.float32))


def _port(x, scale, bias, fs, fb, do_silu, dtype=torch.float32, fn=None):
    fn = fn or tgn.groupnorm_silu_plain
    t = lambda a: None if a is None else torch.from_numpy(a)
    out = fn(torch.from_numpy(x).to(dtype), t(scale), t(bias), t(fs), t(fb),
             do_silu=do_silu)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("c", [96, 128, 384])       # C/32 = 3, 4, 12
@pytest.mark.parametrize("film,do_silu", [(False, True), (True, True), (False, False)])
def test_plain_matches_xla_and_pallas_fp32(c, film, do_silu):
    args = _inputs(c, (2, 6, 5, c), film)
    got = _port(*args, do_silu)
    np.testing.assert_allclose(got, _xla(*args, do_silu), atol=ATOL[np.float32], rtol=0)
    x, scale, bias, fs, fb = args
    pal = pallas_groupnorm_silu(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        None if fs is None else jnp.asarray(fs),
        None if fb is None else jnp.asarray(fb), do_silu=do_silu)
    np.testing.assert_allclose(got, np.asarray(pal), atol=ATOL[np.float32], rtol=0)


@pytest.mark.parametrize("c", [96, 288])
def test_plain_matches_xla_bf16(c):
    args = _inputs(c + 1, (2, 8, 8, c), film=True)
    got = _port(*args, True, dtype=torch.bfloat16)
    ref = _xla(*args, True, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, ref, atol=ATOL["bfloat16"], rtol=0)


def test_fp32_high_mean_low_variance_matches_xla():
    """|mean| >> std, the case of tests/test_pallas_groupnorm.py with its
    tolerance: the one-pass E[x^2]-mean^2 loses the variance in fp32, so the
    port's fp32 path takes the two-pass centred form, as XLA's does."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32) * 0.03 + 100.0
    ones, zeros = np.ones(64, np.float32), np.zeros(64, np.float32)
    got = _port(x, ones, zeros, None, None, False)
    x64 = x.astype(np.float64).reshape(2, 8, 8, 32, 2)
    mu = x64.mean(axis=(1, 2, 4), keepdims=True)
    var = ((x64 - mu) ** 2).mean(axis=(1, 2, 4), keepdims=True)
    exact = ((x64 - mu) / np.sqrt(var + 1e-5)).reshape(2, 8, 8, 64)
    np.testing.assert_allclose(got, exact, atol=1e-3)
    np.testing.assert_allclose(got, _xla(x, ones, zeros, None, None, False), atol=1e-3)


def test_wrapper_takes_plain_version_on_cpu_only():
    args = _inputs(9, (1, 4, 4, 64), film=True)
    LAUNCHES.clear()
    got = _port(*args, True, fn=tgn.groupnorm_silu)
    np.testing.assert_array_equal(got, _port(*args, True))
    assert LAUNCHES["groupnorm_silu"] == 0
    meta = torch.empty((1, 4, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tgn.groupnorm_silu(meta, torch.ones(64), torch.zeros(64))


@pytest.mark.parametrize("batch,hw", [(1, 64), (4, 256), (4, 65536), (16, 16), (2, 100)])
def test_partition_covers_every_pixel(batch, hw):
    slices, per = tgn.partition_pixels(batch, hw)
    assert slices >= 1 and per >= 1
    assert slices * per >= hw and (slices - 1) * per < hw
