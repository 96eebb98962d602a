"""The arithmetic of ``attn_f32_any`` (``diffpir_tpu_torch/kernels/csrc/
attention.cu``): fp32 attention on tensor cores through split-TF32 products,
emulated on the CPU in torch.  Each operand x is split into hi, x rounded to
TF32 to nearest with ties away, and lo = x - hi, of which a TF32 product
reads the TF32 part (its 13 low bits dropped); hi.hi + hi.lo + lo.hi, each
product exact in fp32, are summed in fp32.  The kernel splits Q and K as
loaded, scales the logits by log2(e) / sqrt(ch) (both of the reference's
ch^-1/4 factors and the exp2 base), and splits P after the exponent and V as
loaded.  The emulation is
held against the JAX package's XLA ``_legacy_qkv_attention`` at the fp32
tolerance, and a single TF32 product per fp32 product, the control, must
miss it."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffpir_tpu.models.unet import _legacy_qkv_attention

# the tolerance of tests/test_pallas_attention.py, the kernel's bar on the card
FP32 = dict(atol=2e-5, rtol=1e-4)
LOG2E = 1.4426950408889634
DROPPED = -(1 << 13)  # the mask that clears the 13 mantissa bits TF32 drops


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 to nearest, ties away from zero: half a unit of
    the dropped bits added to the magnitude, then the bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & DROPPED).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 product reads of an fp32 value: its dropped bits cleared."""
    return (x.view(torch.int32) & DROPPED).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_read(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b in fp32 from TF32 products: the split's three (hi.hi, then
    hi.lo + lo.hi, the kernel's three accumulators), or, as the control, one
    product of the operands rounded to TF32."""
    if products == 1:
        return tf32_rna(a) @ tf32_rna(b)
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bh + (ah @ bl + al @ bh)


def split_tf32_attention(qkv: torch.Tensor, heads: int, products: int = 3) -> torch.Tensor:
    b, t, w = qkv.shape
    ch = w // (3 * heads)
    x = qkv.reshape(b, t, heads, 3, ch).permute(3, 0, 2, 1, 4)
    q, k, v = x[0], x[1], x[2]
    s = product(q, k.transpose(-1, -2), products) * (LOG2E / math.sqrt(ch))  # log2 units
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    out = product(p, v, products) / p.sum(-1, keepdim=True)
    return out.permute(0, 2, 1, 3).reshape(b, t, heads * ch)


def _qkv(seed, b, t, heads, ch):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, 3 * heads * ch)).astype(np.float32)


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),          # a tie: away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-11 - 2.0**-23, 1.0),          # below half a unit: down
    (1.0 + 3 * 2.0**-11, 1.0 + 2.0**-9),       # the tie above an odd unit: up
    (2.0 - 2.0**-23, 2.0)])                    # the carry reaches the exponent
def test_tf32_rounding_is_to_nearest_ties_away(x, want):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    assert got.view(torch.int32).item() & ~DROPPED == 0


def test_split_represents_fp32_to_two_parts_in_2_22():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1 << 16).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(hi.view(torch.int32) & ~DROPPED, torch.zeros_like(hi, dtype=torch.int32))
    err = (hi.double() + lo.double() - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0**-21
    assert float((tf32_rna(x).double() - x.double()).abs().div(x.double().abs()).max()) > 2.0**-12


@pytest.mark.parametrize("ch", [24, 96, 256])
def test_split_tf32_matches_xla_at_fp32_tolerance(ch):
    heads = 2
    qkv = _qkv(ch, 2, 64, heads, ch)
    ref = np.asarray(_legacy_qkv_attention(jnp.asarray(qkv), heads))
    got = split_tf32_attention(torch.from_numpy(qkv), heads).numpy()
    np.testing.assert_allclose(got, ref, **FP32)
    # the control: one TF32 product per fp32 product misses the bar
    single = split_tf32_attention(torch.from_numpy(qkv), heads, products=1).numpy()
    assert not np.allclose(single, ref, **FP32)
    assert np.abs(single - ref).max() > 10 * np.abs(got - ref).max()
