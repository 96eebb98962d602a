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
    (1, 1024, 1, 64), (2, 64, 2, 128), (1, 64, 2, 256)])
def test_plain_matches_xla_and_pallas_fp32(b, t, heads, ch):
    qkv = _qkv(t + ch, b, t, heads, ch)
    got = tattn.legacy_qkv_attention_plain(torch.from_numpy(qkv), heads).numpy()
    ref = np.asarray(_legacy_qkv_attention(jnp.asarray(qkv), heads))
    np.testing.assert_allclose(got, ref, **FP32)
    pal = np.asarray(pallas_attention(jnp.asarray(qkv), heads))
    np.testing.assert_allclose(got, pal, **FP32)


@pytest.mark.parametrize("t,heads,ch", [(64, 6, 64), (256, 8, 32), (64, 4, 128),
                                        (64, 2, 256)])
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


# (batch, T, heads, ch) of every attention call on the three paths the port
# is measured on, T = (256 / downsample)^2: demo64_hq (ds 4, 8 heads of 32),
# DEMO256 (ds 16 and the middle block at ds 32, 6 heads of 64 at batch 4),
# diffusion_ffhq_10m at batch 16 (8 heads of 64); the T=1024 check of
# 256x256_diffusion_uncond at ds 8; and ragged shapes
PATH_SHAPES = [(4, 256, 8, 32), (4, 256, 6, 64), (4, 64, 6, 64), (16, 256, 8, 64),
               (16, 64, 8, 64), (4, 1024, 8, 64), (1, 1, 1, 32), (3, 37, 2, 32),
               (2, 100, 2, 64)]


@pytest.mark.parametrize("is_bf16", [True, False])
@pytest.mark.parametrize("b,t,heads,ch", PATH_SHAPES)
def test_rows_per_block_covers_t_within_kernel_limits(b, t, heads, ch, is_bf16):
    for num_sms in (132, 114, 1):
        rows = tattn.attention_rows_per_block(b, t, heads, is_bf16, num_sms)
        assert rows in tattn.ROWS_PER_BLOCK[is_bf16]
        tiles = -(-t // rows)
        assert tiles * rows >= t and (tiles - 1) * rows < t
        # the largest tile that still gives every SM a block
        larger = [r for r in tattn.ROWS_PER_BLOCK[is_bf16] if r > rows]
        assert all(b * heads * -(-t // r) < num_sms for r in larger)
    # the same shapes through the variant that takes them
    plan = tattn.attention_plan(b, t, heads, ch, is_bf16)
    assert plan.variant == "tuned" and plan.slices == 1
    assert plan.rows in tattn.ROWS_PER_BLOCK[is_bf16]


def test_misaligned_qkv_is_refused_before_any_build(monkeypatch):
    from diffpir_tpu_torch.kernels import build

    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(build, "load_library", no_build)
    n = 64 * 192
    flat = torch.zeros(n + 8, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    shifted = flat[1:1 + n].view(1, 64, 192)  # 2 bytes past a 16-byte boundary
    assert shifted.is_contiguous()
    with pytest.raises(ValueError, match="16-byte boundary"):
        tattn.check_inputs(shifted, 2)
    assert tattn.check_inputs(flat[8:].view(1, 64, 192), 2) == 32


@pytest.mark.parametrize("b,t,heads,ch", [(1, 64, 2, 320), (2, 48, 1, 512)])
def test_wide_heads_plain_matches_xla_and_pallas(b, t, heads, ch):
    """Head widths above 256 (fault C5: a num_head_channels of -1 with one
    or two heads): the wrapper's CPU route against the XLA path and the
    Pallas kernel in interpret mode, as for the narrow widths."""
    qkv = _qkv(ch, b, t, heads, ch)
    assert tattn.check_inputs(torch.from_numpy(qkv), heads) == ch
    got = tattn.legacy_qkv_attention(torch.from_numpy(qkv), heads).numpy()
    ref = np.asarray(_legacy_qkv_attention(jnp.asarray(qkv), heads))
    np.testing.assert_allclose(got, ref, **FP32)
    pal = np.asarray(pallas_attention(jnp.asarray(qkv), heads))
    np.testing.assert_allclose(got, pal, **FP32)


# (dtype, ch, heads) on either side of each boundary between the variants:
# the tuned widths, attn_f32_any's 256 channels, the tuned kernels' grid y
# of 65535 heads (attn_f32_any puts its pairs on grid x, so it takes any
# head count, the tuned widths' past 65535 in fp32 too)
VARIANT_BOUNDARIES = [
    (True, 64, 1, "tuned"), (True, 65, 1, "bf16_any"),
    (False, 64, 1, "tuned"), (False, 65, 1, "f32_any"),
    (True, 256, 1, "bf16_any"), (True, 257, 1, "bf16_any"),
    (False, 256, 1, "f32_any"), (False, 257, 1, "f32_wide"),
    (True, 32, 65535, "tuned"), (True, 32, 65536, "bf16_any"),
    (False, 32, 65535, "tuned"), (False, 32, 65536, "f32_any"),
    (True, 96, 65535, "bf16_any"), (True, 96, 65536, "bf16_any"),
    (False, 96, 65535, "f32_any"), (False, 96, 65536, "f32_any"),
    (False, 256, 65536, "f32_any"), (False, 257, 65536, "f32_wide")]


@pytest.mark.parametrize("is_bf16,ch,heads,variant", VARIANT_BOUNDARIES)
def test_attention_variant_at_each_boundary(is_bf16, ch, heads, variant):
    """One function names the kernel; the plan the wrapper hands the C entry
    follows it, and the C entry's variant number exists."""
    assert tattn.attention_variant(is_bf16, ch, heads) == variant
    plan = tattn.attention_plan(2, 64, heads, ch, is_bf16)
    assert plan.variant == variant and variant in tattn.VARIANTS
    if variant == "tuned":
        assert plan.rows in tattn.ROWS_PER_BLOCK[is_bf16]
    elif variant == "bf16_any":
        assert plan.rows in tattn.BF16_ANY_ROWS
        assert plan.slice_ch in tattn.BF16_SLICE_CHANNELS
    elif variant == "f32_any":
        groups = plan.rows // tattn.f32_any_group_rows(ch)
        assert ((groups, plan.key_splits) in tattn.F32_ANY_SHAPES
                or (groups, plan.key_splits) == tattn.F32_ANY_NARROW)
        assert plan.slice_ch == ch and plan.slices == 1
    else:
        assert plan.rows == tattn.VARIANT_ROWS[variant]


@pytest.mark.parametrize("b,t,heads", [(1, 1, 1), (4, 4096, 2), (40000, 3, 2), (1, 65536, 1)])
def test_sliced_kernels_cover_the_head_within_grid_limits(b, t, heads):
    """attn_bf16_any and attn_wide put (pair, query tile, slice) on grid x:
    their slices cover the head width once, each within what a block keeps
    in registers (attn_wide's in whole chunks of 64 channels), and the
    blocks stay within grid x, at heads of 320, 1024 and 2048 channels (and
    96 in bf16, which slices only for parallelism)."""
    for is_bf16, ch in ((True, 96), (True, 320), (True, 1024), (True, 2048),
                        (False, 320), (False, 1024), (False, 2048)):
        plan = tattn.attention_plan(b, t, heads, ch, is_bf16)
        assert plan.variant == ("bf16_any" if is_bf16 else "f32_wide")
        assert plan.slices * plan.slice_ch >= ch > (plan.slices - 1) * plan.slice_ch
        widest = (tattn.BF16_SLICE_CHANNELS if is_bf16 else tattn.WIDE_SLICE_CHANNELS)[-1]
        assert plan.slice_ch <= widest and plan.slices >= -(-ch // widest)
        if not is_bf16:
            assert plan.slice_ch % 64 == 0
        assert plan.blocks == b * heads * -(-t // plan.rows) * plan.slices
        assert 1 <= plan.blocks <= tattn.MAX_GRID_X
        if plan.rows == tattn.BF16_ANY_ROWS[0]:
            assert ch <= tattn.BF16_ANY_TWO_WG_MAX_CH
    with pytest.raises(ValueError, match="more than a grid holds"):
        tattn.attention_plan(1 << 22, 1 << 16, 1, 320, True)


@pytest.mark.parametrize("b,t,heads", [(1, 1, 1), (4, 4096, 2), (40000, 3, 2)])
@pytest.mark.parametrize("ch", [1, 96, 256])
def test_f32_any_grid_covers_pairs_and_query_tiles(b, t, heads, ch):
    """attn_f32_any puts (pair, query tile, key chunk) on grid x: one block
    for each, within grid x, each of eight warps (row groups of 32 or 16
    query rows times warps splitting the keys; four above 128 channels where
    eight would leave half the SMs idle) and within a block's shared memory;
    the most rows whose grid still gives every SM a block, else the
    fewest."""
    gr = tattn.f32_any_group_rows(ch)
    assert gr == (32 if ch <= 128 else 16)
    for num_sms in (132, 114, 1):
        plan = tattn.attention_plan(b, t, heads, ch, False, num_sms)
        assert plan.variant == "f32_any"
        groups, splits = plan.rows // gr, plan.key_splits
        assert groups * gr == plan.rows
        if (groups, splits) == tattn.F32_ANY_NARROW:
            # four warps: one m-tile a warp, and eight would idle half the SMs
            assert gr == 16
            assert all(2 * b * heads * -(-t // (gr * g)) <= num_sms
                       for g, k in tattn.F32_ANY_SHAPES
                       if tattn.f32_any_smem(ch, gr * g, k) <= tattn.MAX_SMEM)
        else:
            assert (groups, splits) in tattn.F32_ANY_SHAPES
        assert plan.slice_ch == ch and plan.slices == 1
        tiles = -(-t // plan.rows)
        assert tiles * plan.rows >= t > (tiles - 1) * plan.rows
        # the keys in chunks, a block each, only where the grid would leave
        # half the SMs idle and the keys span a few tiles, each chunk at
        # least one key tile
        key_tiles = -(-t // (tattn.F32_ANY_WARP_KEYS * splits))
        assert 1 <= plan.kv_chunks <= min(tattn.F32_ANY_MAX_CHUNKS, key_tiles)
        if plan.kv_chunks > 1:
            assert 2 * b * heads * tiles <= num_sms
            assert key_tiles >= tattn.F32_ANY_CHUNK_MIN_TILES
        assert plan.blocks == b * heads * tiles * plan.kv_chunks
        assert 1 <= plan.blocks <= tattn.MAX_GRID_X
        assert tattn.f32_any_smem(ch, plan.rows, splits) <= tattn.MAX_SMEM
        if (groups, splits) != tattn.F32_ANY_NARROW:
            more_rows = [gr * g for g, k in tattn.F32_ANY_SHAPES if gr * g > plan.rows
                         and tattn.f32_any_smem(ch, gr * g, k) <= tattn.MAX_SMEM]
            assert all(b * heads * -(-t // r) < num_sms for r in more_rows)
