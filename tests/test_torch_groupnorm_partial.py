"""The sharded GroupNorm's partial-statistics launch on the CPU: its plan
(``kernels/groupnorm.py::partial_plan``) at every shard shape a ``space``
rank gives it, and the kernel's order of work (``csrc/groupnorm_partial.cu``:
channel chunks, pixel segments, the channels of a group and the segments
joined in ``warp_join``'s tree) replayed in numpy for
plans of every kind, against the plain version, whose merged statistics are
held to the same statistics in ``jax.numpy``.  The kernel itself runs only on the card
(``chip_smoke.py`` phase kernels, ``scripts/gn_partial_probe.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpir_tpu_torch.kernels import groupnorm as kgn

# a space rank's shards (half the rows, batch 4) of DEMO256 (bf16) and
# demo64 (fp32), and the classifier head's one pixel of 2048 channels
SHARDS = ([((4, h, 2 * h, c), 2) for h, c in
           ((128, 96), (128, 192), (64, 96), (64, 192), (64, 288), (32, 96), (32, 192),
            (32, 288), (32, 384), (16, 192), (16, 384), (16, 576), (8, 192), (8, 384),
            (8, 576), (8, 768), (4, 384), (4, 768))]
          + [((4, h, 2 * h, c), 4) for h, c in
             ((32, 128), (32, 256), (32, 384), (16, 128), (16, 256), (16, 384), (16, 512),
              (8, 256), (8, 512))]
          + [((8, 1, 1, 2048), 2), ((8, 1, 1, 2048), 4), ((1, 3, 5, 64), 4)])


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("shape,itemsize", SHARDS, ids=lambda v: str(v))
def test_plan_is_one_the_kernel_takes(shape, itemsize):
    b, h, w, c = shape
    plan = kgn.partial_plan(b, h * w, c, itemsize)
    vec = 16 // itemsize
    cc = c // plan.chunks
    assert 32 % plan.chunks == 0 and cc % vec == 0 and cc % (c // 32) == 0
    assert 1 <= plan.segments <= 32
    threads = -(-(cc // vec * plan.rows) // 32) * 32
    assert 1 <= plan.rows and threads <= 512
    # no empty segment, and no more rows than a segment has pixels
    per_seg = -(-h * w // plan.segments)
    assert (plan.segments - 1) * per_seg < h * w
    assert plan.rows <= max(1, per_seg)


def _tree(items, join):
    """warp_join's order over up to 32 lanes: lane l takes lane l + o for
    o = 16, 8, 4, 2, 1; the result is lane 0's."""
    lanes = list(items) + [None] * (32 - len(items))
    o = 16
    while o:
        for l in range(32 - o):
            if lanes[l + o] is not None:
                lanes[l] = lanes[l + o] if lanes[l] is None else join(lanes[l], lanes[l + o])
        o //= 2
    return lanes[0]


def _chan(a, b):
    f = np.float32
    n, mu, m2 = a
    nb, mub, m2b = b
    if nb == 0:
        return a
    if n == 0:
        return b
    nt = f(n + nb)
    d = f(mub - mu)
    w = f(nb / nt)
    return nt, f(mu + d * w), f(m2 + m2b + d * d * f(n * w))


def _sums(a, b):
    return a[0], np.float32(a[1] + b[1]), np.float32(a[2] + b[2])


def _emulated(x: np.ndarray, plan, centred: bool) -> np.ndarray:
    """The kernel's partition and join order, in float32 numpy (the sums
    over a slice's pixels in float64, which only the rounding tells apart)."""
    b, h, w, c = x.shape
    hw, g = h * w, 32
    cg, gc, cc = c // g, g // plan.chunks, c // plan.chunks
    xs = x.reshape(b, hw, c).astype(np.float64)
    seg = -(-hw // plan.segments)
    out = np.zeros((b, g, 3), np.float32)
    join = _chan if centred else _sums
    for bi in range(b):
        for k in range(plan.chunks):
            for grp in range(gc):
                gg = k * gc + grp
                chans = range(gg * cg, (gg + 1) * cg)
                segs = []
                for m in range(plan.segments):
                    p0, p1 = min(hw, m * seg), min(hw, m * seg + seg)
                    px = xs[bi, p0:p1]
                    npx = np.float32(p1 - p0)
                    per_chan = []
                    for ch in chans:
                        v = px[:, ch]
                        if centred:
                            if len(v) == 0:
                                continue
                            d = v - v[0]
                            t1, t2 = np.float32(d.sum()), np.float32((d * d).sum())
                            mean = np.float32(t1 / npx)
                            per_chan.append((npx, np.float32(np.float32(v[0]) + mean),
                                             np.float32(max(t2 - t1 * mean, 0.0))))
                        else:
                            per_chan.append((npx, np.float32(v.sum()),
                                             np.float32((v * v).sum())))
                    r = _tree(per_chan, join) if per_chan else (np.float32(0), 0, 0)
                    segs.append((np.float32((p1 - p0) * cg), r[1], r[2]))
                r = _tree(segs, join)
                n_all = np.float32(hw * cg)
                out[bi, gg] = (n_all, r[1], r[2]) if centred else (r[1], r[2], n_all)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plan", [
    kgn.PartialPlan(1, 4), kgn.PartialPlan(2, 2, 7), kgn.PartialPlan(4, 1, 23),
    kgn.PartialPlan(8, 3, 5), kgn.PartialPlan(1, 2, 32),
    kgn.PartialPlan(2, 8, 3)], ids=lambda p: "x".join(map(str, p)))
def test_kernel_order_of_work_matches_plain(plan, dtype):
    """Segments and chunks of every kind, empty segments included (7
    segments of a 23-pixel shard, the last empty; 32 segments of it): the
    kernel's joins give the plain version's statistics."""
    rng = np.random.default_rng(plan.chunks * 7 + plan.segments)
    x = (rng.standard_normal((2, 1, 23, 64)) * 0.7 + 0.3).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = kgn.groupnorm_partial_stats_plain(t, 32).numpy()
    got = _emulated(t.float().numpy(), plan, dtype == "float32")
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_plain_statistics_equal_jax_groupnorm():
    """The merged partial statistics of two row shards (fp32) against the
    whole image's group mean and variance in ``jax.numpy``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 5, 64)).astype(np.float32) * 2 + 1
    parts = torch.stack([kgn.groupnorm_partial_stats_plain(torch.from_numpy(p), 32)
                         for p in (x[:, :3], x[:, 3:])])
    mean, rstd = kgn.merge_partial_stats(parts, False).unbind(-1)
    xg = jnp.asarray(x).reshape(2, -1, 32, 2)
    jmean = np.asarray(xg.mean(axis=(1, 3)))
    jvar = np.asarray(((xg - xg.mean(axis=(1, 3), keepdims=True)) ** 2).mean(axis=(1, 3)))
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(jvar + 1e-5), rtol=1e-5)
