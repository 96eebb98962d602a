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


# (B, H*W, C, itemsize): GroupNorm layers of the three paths the port is
# measured on (demo64_hq fp32, DEMO256 bf16, diffusion_ffhq_10m bf16 at batch
# 16), at their extremes of width and size, and small ragged ones
LAYOUT_CASES = [(4, 64 * 64, 128, 4), (4, 8 * 8, 512, 4), (4, 16 * 16, 384, 4),
                (4, 256 * 256, 96, 2), (4, 128 * 128, 288, 2), (4, 8 * 8, 768, 2),
                (16, 256 * 256, 128, 2), (16, 8 * 8, 1024, 2), (2, 35, 96, 4),
                (1, 1, 32, 2)]


@pytest.mark.parametrize("batch,hw,c,itemsize", LAYOUT_CASES)
def test_launch_geometry_covers_every_element_once(batch, hw, c, itemsize):
    """Both launches: thread i of a block always reads vector column
    i % vectors (fixed channels), and the threads of the statistics blocks
    (one per slice) and of the apply items each cover every (pixel, vector)
    of a sample exactly once."""
    vec, nv, rows = tgn.thread_layout(c, itemsize)
    assert vec * nv == c and vec * itemsize == 16
    assert 1 <= nv * rows <= tgn.MAX_THREADS
    assert 2 * 4 * rows * c <= tgn.MAX_STATIC_SMEM
    thread = np.arange(nv * rows)
    col, row = thread % nv, thread // nv
    slices, per = tgn.partition_pixels(batch, hw)
    seen = np.zeros((hw, nv), np.int64)
    for s in range(slices):  # gn_stats: pixels p0 + row, p0 + row + rows, ...
        p0, p1 = s * per, min(hw, (s + 1) * per)
        assert p1 > p0
        for k in range(-(-(p1 - p0) // rows)):
            p = p0 + row + k * rows
            ok = p < p1
            np.add.at(seen, (p[ok], col[ok]), 1)
    assert (seen == 1).all()
    seen[:] = 0
    chunk = 4 * rows  # gn_apply: item q is pixels q*chunk + row + k*rows, k < 4
    for q in range(-(-hw // chunk)):
        for k in range(4):
            p = q * chunk + row + k * rows
            ok = p < hw
            np.add.at(seen, (p[ok], col[ok]), 1)
    assert (seen == 1).all()


def _chan(a, b):
    """(n, mean, M2) of two disjoint sets -> of their union, in float32."""
    n, mu, m2 = a
    nb, mub, m2b = b
    if nb == 0:
        return a
    if n == 0:
        return b
    nt = np.float32(n + nb)
    d = np.float32(mub - mu)
    return (nt, np.float32(mu + d * np.float32(nb / nt)),
            np.float32(m2 + m2b + d * d * np.float32(n * nb / nt)))


def _kernel_fp32_stats(x, groups=32):
    """numpy float32 emulation of csrc/groupnorm.cu's fp32 statistics, in the
    kernel's order: per slice, shifted sums by fixed-channel threads, rows
    added in order, per-channel (mean, M2), channels of a group joined
    exactly; then the last block's fixed-order Chan merge over the slices.
    Returns (mean, var) per (sample, group)."""
    b, hw, c = x.shape
    _, nv, rows = tgn.thread_layout(c, 4)
    slices, per = tgn.partition_pixels(b, hw)
    cg = c // groups
    threads = nv * rows
    mean = np.zeros((b, groups), np.float32)
    var = np.zeros((b, groups), np.float32)
    for i in range(b):
        parts = []
        for s in range(slices):
            p0, p1 = s * per, min(hw, (s + 1) * per)
            xs = x[i, p0:p1]
            shift = xs[0]
            a1 = np.zeros((rows, c), np.float32)
            a2 = np.zeros((rows, c), np.float32)
            for k in range(-(-(p1 - p0) // rows)):  # thread row r: pixel k*rows + r
                blk = xs[k * rows:(k + 1) * rows] - shift
                a1[:len(blk)] += blk
                a2[:len(blk)] += blk * blk
            t1 = np.zeros(c, np.float32)
            t2 = np.zeros(c, np.float32)
            for r in range(rows):
                t1 += a1[r]
                t2 += a2[r]
            n_p = np.float32(p1 - p0)
            mc = shift + t1 / n_p
            m2c = np.maximum(t2 - t1 * (t1 / n_p), np.float32(0))
            mg = mc.reshape(groups, cg).sum(-1, dtype=np.float32) / np.float32(cg)
            dev = mc.reshape(groups, cg) - mg[:, None]
            m2g = (m2c.reshape(groups, cg) + n_p * dev * dev).sum(-1, dtype=np.float32)
            parts.append((n_p * cg, mg, m2g))
        lanes = threads // groups  # threads per group in the final merge
        for g in range(groups):
            acc = []
            for lane in range(lanes):
                st = (np.float32(0), np.float32(0), np.float32(0))
                for s in range(lane, slices, lanes):
                    st = _chan(st, (np.float32(parts[s][0]), parts[s][1][g], parts[s][2][g]))
                acc.append(st)
            st = (np.float32(0), np.float32(0), np.float32(0))
            for a in acc:
                st = _chan(st, a)
            mean[i, g] = st[1]
            var[i, g] = st[2] / np.float32(hw * cg)
    return mean, var


def test_chan_merge_emulation_matches_two_pass_on_high_mean():
    """The kernel's one-read fp32 statistics (emulated in float32) match the
    two-pass centred statistics of the plain version on the high-mean case,
    where the one-pass E[x^2]-mean^2 does not."""
    rng = np.random.default_rng(5)
    b, h, w, c = 2, 16, 16, 64
    x = (rng.standard_normal((b, h * w, c)) * 0.03 + 100.0).astype(np.float32)
    mean, var = _kernel_fp32_stats(x)
    x64 = x.astype(np.float64).reshape(b, h * w, 32, 2)
    mu = x64.mean(axis=(1, 3))
    v = ((x64 - mu[:, None, :, None]) ** 2).mean(axis=(1, 3))
    # the normalised values the two statistics give differ by < 1e-3
    np.testing.assert_allclose(mean, mu, rtol=0, atol=1e-5)
    np.testing.assert_allclose(var, v, rtol=1e-3)
    got = (x64 - mean[:, None, :, None]) / np.sqrt(var[:, None, :, None] + 1e-5)
    plain = _port(x.reshape(b, h, w, c), np.ones(c, np.float32), np.zeros(c, np.float32),
                  None, None, False)
    np.testing.assert_allclose(got.reshape(b, h, w, c), plain, atol=1e-3)
    # the one-pass form in float32 loses the variance here
    xf = x.reshape(b, h * w, 32, 2)
    one_pass = (xf * xf).mean(axis=(1, 3), dtype=np.float32) - xf.mean(axis=(1, 3), dtype=np.float32) ** 2
    assert np.abs(one_pass - v).max() > 10 * np.abs(var - v).max()


def test_misaligned_x_is_refused_before_any_build(monkeypatch):
    from diffpir_tpu_torch.kernels import build

    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(build, "load_library", no_build)
    n = 4 * 4 * 64
    flat = torch.zeros(n + 4)
    assert flat.data_ptr() % 16 == 0
    ones, zeros = torch.ones(64), torch.zeros(64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        tgn.check_inputs(flat[1:1 + n].view(1, 4, 4, 64), ones, zeros)
    assert tgn.check_inputs(flat[4:].view(1, 4, 4, 64), ones, zeros) == (4, 16, 16)
    with pytest.raises(ValueError, match="multiple of 8"):
        tgn.check_inputs(torch.zeros((1, 4, 4, 36), dtype=torch.bfloat16),
                         torch.ones(36), torch.zeros(36), num_groups=4)


def test_ticket_counters_are_never_made_during_graph_capture(monkeypatch):
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(tgn, "_COUNTERS", {})
    dev = torch.device("cpu")
    capturing[0] = True
    with pytest.raises(RuntimeError, match="before the CUDA-graph capture"):
        tgn._counters(dev, 7, 4)
    assert tgn._COUNTERS == {}
    capturing[0] = False
    buf = tgn._counters(dev, 7, 4)
    assert buf.dtype == torch.int32 and buf.numel() >= 4 and not buf.any()
    capturing[0] = True
    assert tgn._counters(dev, 7, 4) is buf            # made before: reused
    with pytest.raises(RuntimeError, match="before the CUDA-graph capture"):
        tgn._counters(dev, 7, buf.numel() + 1)          # would have to grow
    with pytest.raises(RuntimeError, match="before the CUDA-graph capture"):
        tgn._counters(dev, 8, 4)                        # another stream


# -- the two halves of the sharded GroupNorm (spatial parallelism) ----------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_halves_match_xla(dtype, shards):
    """Partial statistics of each row shard, merged in shard order, then the
    apply half on each shard: the whole image's GroupNorm+FiLM+SiLU, as the
    JAX package's XLA path computes it (one shard: the plain version bit for
    bit)."""
    x, scale, bias, fs, fb = _inputs(11, (2, 16, 8, 64), True)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    xt = torch.from_numpy(x).to(tdt)
    args = (torch.from_numpy(scale), torch.from_numpy(bias), torch.from_numpy(fs),
            torch.from_numpy(fb))
    rows = xt.shape[1] // shards
    parts = [xt[:, i * rows:(i + 1) * rows] for i in range(shards)]
    stats = tgn.merge_partial_stats(
        torch.stack([tgn.groupnorm_partial_stats(p) for p in parts]), tdt == torch.bfloat16)
    assert stats.shape == (2, 32, 2) and stats.dtype == torch.float32
    got = torch.cat([tgn.groupnorm_apply_stats(p, args[0], args[1], stats, *args[2:])
                     for p in parts], dim=1)
    ref = _xla(x, scale, bias, fs, fb, True,
               jnp.float32 if dtype is np.float32 else jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=ATOL[dtype], rtol=0)
    if shards == 1:
        plain = tgn.groupnorm_silu_plain(xt, *args)
        assert torch.equal(got, plain)


def test_partial_stats_layout_and_plain_on_cpu():
    """fp32 partials are (n, mean, M2), bf16 (sum x, sum x^2, n); the
    wrappers run their plain versions on the CPU and launch nothing."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 32)).astype(np.float32))
    LAUNCHES.clear()
    f32 = tgn.groupnorm_partial_stats(x)
    g = x.reshape(1, 16, 32, 1).reshape(1, 16, 32)  # 32 groups of one channel
    np.testing.assert_allclose(f32[0, :, 0].numpy(), 16.0)
    np.testing.assert_allclose(f32[0, :, 1].numpy(), g.mean(1)[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(f32[0, :, 2].numpy(),
                               ((g - g.mean(1, keepdim=True)) ** 2).sum(1)[0].numpy(),
                               atol=1e-5)
    xb = x.to(torch.bfloat16)
    b16 = tgn.groupnorm_partial_stats(xb)
    gb = xb.float().reshape(1, 16, 32)
    np.testing.assert_allclose(b16[0, :, 0].numpy(), gb.sum(1)[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(b16[0, :, 1].numpy(), (gb ** 2).sum(1)[0].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(b16[0, :, 2].numpy(), 16.0)
    assert LAUNCHES["groupnorm_partial_stats"] == LAUNCHES["groupnorm_apply_stats"] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tgn.groupnorm_partial_stats(torch.empty((1, 4, 4, 32), device="meta"))
