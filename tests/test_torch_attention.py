"""The port's legacy-QKV attention against the JAX package: the XLA path
(``_legacy_qkv_attention``) and the Pallas kernel in interpret mode.  On the
CPU the wrapper runs the plain version; the CUDA kernel is held against it on
the card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffpir_tpu.models.unet import _legacy_qkv_attention
from diffpir_tpu.pallas.attention import legacy_qkv_attention as pallas_attention
from diffpir_tpu_torch.kernels import LAUNCHES
from diffpir_tpu_torch.kernels import attention as tattn

# the tolerances of tests/test_pallas_attention.py
FP32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)


def _qkv(seed, b, t, heads, ch):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, 3 * heads * ch)).astype(np.float32)


@pytest.mark.parametrize("b,t,heads,ch", [
    (2, 64, 2, 32), (2, 64, 2, 64), (1, 256, 2, 32), (1, 256, 2, 64),
    (1, 1024, 1, 64)])
def test_plain_matches_xla_and_pallas_fp32(b, t, heads, ch):
    qkv = _qkv(t + ch, b, t, heads, ch)
    got = tattn.legacy_qkv_attention_plain(torch.from_numpy(qkv), heads).numpy()
    ref = np.asarray(_legacy_qkv_attention(jnp.asarray(qkv), heads))
    np.testing.assert_allclose(got, ref, **FP32)
    pal = np.asarray(pallas_attention(jnp.asarray(qkv), heads))
    np.testing.assert_allclose(got, pal, **FP32)


@pytest.mark.parametrize("t,heads,ch", [(64, 6, 64), (256, 8, 32)])
def test_plain_matches_xla_bf16(t, heads, ch):
    qkv = _qkv(7, 1, t, heads, ch)
    got = tattn.legacy_qkv_attention_plain(
        torch.from_numpy(qkv).to(torch.bfloat16), heads)
    assert got.dtype == torch.bfloat16
    ref = _legacy_qkv_attention(jnp.asarray(qkv, jnp.bfloat16), heads)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **BF16)


def test_wrapper_takes_plain_version_on_cpu_only():
    qkv = torch.from_numpy(_qkv(3, 1, 64, 2, 32))
    LAUNCHES.clear()
    out = tattn.legacy_qkv_attention(qkv, 2)
    np.testing.assert_array_equal(out.numpy(),
                                  tattn.legacy_qkv_attention_plain(qkv, 2).numpy())
    assert LAUNCHES["legacy_qkv_attention"] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.legacy_qkv_attention(torch.empty((1, 64, 192), device="meta"), 2)
