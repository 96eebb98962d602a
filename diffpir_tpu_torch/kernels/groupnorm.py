"""GroupNorm (fp32 statistics) + optional FiLM + optional SiLU on NHWC tensors.

Port of the TPU kernel ``diffpir_tpu/pallas/groupnorm.py::groupnorm_silu``
(defined at ``:73``, ``pl.pallas_call`` at ``:100``, body ``_kernel`` at
``:33-68``) to the CUDA kernel in
``csrc/groupnorm.cu``.  Both functions here compute what ``GroupNorm32``'s XLA
path computes (``diffpir_tpu/models/unet.py:83-131``): per-group fp32 mean
and variance over H*W*(C/G), eps 1e-5, the affine step, optional FiLM
``y*(1+fs)+fb``, optional SiLU, output in the input's type.  fp32 inputs use
a centred variance (the plain version two passes; the kernel per-block
centred sums merged with Chan's formula, one read); bf16 inputs the one-pass
E[x^2]-mean^2, clamped at 0.  The kernel makes two launches per call.

For an image whose rows are spread over several ranks (spatial
parallelism) the call splits in two: ``groupnorm_partial_stats`` returns a
shard's unfinished statistics per (sample, group), bf16 (sum x, sum x^2, n)
and fp32 (n, mean, M2); the caller gathers the shards' and
``merge_partial_stats`` joins them in rank order into (mean, rstd);
``groupnorm_apply_stats`` normalises from those.  Each has a plain version.
The partial statistics are a kernel of their own (``csrc/groupnorm_partial.cu``,
cut per shape by ``partial_plan``); the apply launch is ``gn_apply`` of
``csrc/groupnorm.cu``.

Each entry runs the plain version for a CPU tensor and the CUDA kernel for a
CUDA tensor; it never falls back from one to the other.  Where a gradient is
asked for (grad mode on and an input that requires one), the launch (on the
CPU the plain version) runs inside an ``autograd.Function`` (``GroupNormSiLUFunction``,
``PartialStatsFunction``, ``ApplyStatsFunction``) whose backward recomputes
the plain version and differentiates it (the TPU kernel has no backward
kernel to port, and the kernels stay forward-only).

Each entry is also an operator, ``torch.ops.diffpir_tpu_torch.groupnorm_silu``,
``::groupnorm_partial_stats`` and ``::groupnorm_apply_stats``
(``_common.define_op``): the CPU implementation is the plain version, the
CUDA one the launch, a fake one gives the output's shape and type.  Each
has an autograd formula that calls its backward operator
(``::groupnorm_silu_backward`` and so on: the same recompute, on both
keys), so a ``make_fx`` record of a gradient holds one forward and one
backward node per call.  ``merge_partial_stats``, the host-side join
between the halves, is the operator ``::groupnorm_merge_stats``.  While a
program is recorded (a ``torch.export`` trace, ``_common.operators()``)
the wrappers emit the operators, so an exported program holds one opaque
node per call and no plain-version subgraph; an eager call keeps the
direct path, without the operator's dispatch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from diffpir_tpu_torch.kernels import LAUNCHES
from diffpir_tpu_torch.kernels._common import (check_aligned,
                                               check_cuda_tensor,
                                               current_stream_handle, define_op,
                                               emit_operators, raise_on_error,
                                               recompute_grads, wants_grad)

__all__ = ["groupnorm_silu", "groupnorm_silu_plain", "GroupNormSiLUFunction",
           "groupnorm_silu_backward", "partition_pixels", "thread_layout",
           "check_inputs", "groupnorm_partial_stats", "groupnorm_partial_stats_plain",
           "partial_plan", "PartialPlan",
           "PartialStatsFunction", "groupnorm_apply_stats", "groupnorm_apply_stats_plain",
           "ApplyStatsFunction", "merge_partial_stats"]

_OPS = torch.ops.diffpir_tpu_torch

MAX_GROUPS = 64           # csrc/groupnorm.cu kMaxGroups
MAX_THREADS = 1024        # threads per block
MAX_STATIC_SMEM = 48 * 1024
_TARGET_BLOCKS = 528      # ~4 statistics blocks per SM of a 132-SM card: one wave
_MIN_SLICE = 64           # pixels per statistics block, at least
_ROW_THREADS = 256        # threads per block to aim for
# the partial-statistics launch (partial_plan)
_PARTIAL_ALIGN_BYTES = 5 << 20      # "large": chunks of whole 32-byte sectors
_PARTIAL_SINGLE_ELEMS = 16 << 10    # a (sample, chunk) one block reads alone
_PARTIAL_SMALL_THREADS = 128        # threads of such a block, in bf16 (fp32 256)
_PARTIAL_BLOCKS = 128               # blocks of a segmented launch (large: 256)

# per-(device, stream) ticket counters of the statistics launch; the kernel
# leaves them at 0, so each buffer is zeroed once, when it is made, and never
# while a CUDA graph is captured (the zero-fill would exist only in that graph)
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def groupnorm_silu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         film_scale: Optional[torch.Tensor] = None,
                         film_shift: Optional[torch.Tensor] = None, *,
                         num_groups: int = 32, eps: float = 1e-5,
                         do_silu: bool = True) -> torch.Tensor:
    """The same function in PyTorch operations, step for step as XLA's path."""
    dtype = x.dtype
    b, c = x.shape[0], x.shape[-1]
    g = num_groups
    spatial = tuple(range(1, x.ndim - 1))
    bshape = (b,) + (1,) * (x.ndim - 2) + (c,)
    n = float(math.prod(x.shape[1:-1]) * (c // g))
    xf = x.float()
    mean = xf.sum(dim=spatial).reshape(b, g, c // g).sum(-1) / n
    if dtype == torch.float32:
        mean_full = mean.repeat_interleave(c // g, dim=-1).reshape(bshape)
        d2 = (xf - mean_full).square().sum(dim=spatial)
        var = d2.reshape(b, g, c // g).sum(-1) / n
    else:
        gs2 = xf.square().sum(dim=spatial).reshape(b, g, c // g).sum(-1)
        var = (gs2 / n - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    w = inv.repeat_interleave(c // g, dim=-1) * scale.float()[None]
    off = bias.float()[None] - mean.repeat_interleave(c // g, dim=-1) * w
    if film_scale is not None:
        f = 1.0 + film_scale.float()
        w = w * f
        off = off * f + film_shift.float()
    y = xf * w.reshape(bshape) + off.reshape(bshape)
    if do_silu:
        y = F.silu(y)
    return y.to(dtype)


def partition_pixels(batch: int, hw: int) -> tuple[int, int]:
    """(slices, pixels per slice) for the statistics launch: enough blocks
    to fill the card, at least ``_MIN_SLICE`` pixels each, none empty."""
    want = max(1, -(-_TARGET_BLOCKS // batch))
    slices = max(1, min(want, -(-hw // _MIN_SLICE)))
    per = -(-hw // slices)
    return -(-hw // per), per


def thread_layout(c: int, itemsize: int) -> tuple[int, int, int]:
    """(channels per 16-byte vector, vectors per pixel, pixel rows) of a
    block of both launches.  Thread ``i`` of the block's ``vectors * rows``
    always reads vector column ``i % vectors`` (channels ``vec*(i % vectors)``
    onward) of pixel row ``i // vectors``, so its channels never change."""
    vec = 16 // itemsize
    if c % vec:
        raise ValueError(f"groupnorm_silu: C={c} is not a multiple of {vec} "
                         f"(16-byte vectors of {itemsize}-byte elements)")
    nv = c // vec
    rows = max(1, _ROW_THREADS // nv)
    if nv * rows > MAX_THREADS or 2 * 4 * rows * c > MAX_STATIC_SMEM:
        raise ValueError(f"groupnorm_silu: C={c} is too wide for one block")
    return vec, nv, rows


def _check_x(x: torch.Tensor, num_groups: int) -> tuple[int, int, int]:
    if x.ndim != 4:
        raise ValueError(f"groupnorm_silu takes (B, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    if num_groups > MAX_GROUPS or c % num_groups:
        raise ValueError(f"groupnorm_silu: C={c} with {num_groups} groups "
                         f"(need C % G == 0 and G <= {MAX_GROUPS})")
    check_cuda_tensor("x", x, x.device)
    check_aligned("x", x)
    return thread_layout(c, x.element_size())


def check_inputs(x, scale, bias, film_scale=None, film_shift=None, *,
                 num_groups: int = 32) -> tuple[int, int, int]:
    """Raise unless the kernel takes these arguments (shapes, types,
    contiguity, 16-byte alignment of ``x``); returns ``thread_layout``."""
    _check_x(x, num_groups)
    b, _, _, c = x.shape
    if (film_scale is None) != (film_shift is None):
        raise ValueError("film_scale and film_shift go together")
    dev = x.device
    f32 = (torch.float32,)
    check_cuda_tensor("scale", scale, dev, f32, (c,))
    check_cuda_tensor("bias", bias, dev, f32, (c,))
    if film_scale is not None:
        check_cuda_tensor("film_scale", film_scale, dev, f32, (b, c))
        check_cuda_tensor("film_shift", film_shift, dev, f32, (b, c))
    return thread_layout(c, x.element_size())


def _counters(dev: torch.device, stream: int, batch: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < batch:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"groupnorm_silu: no ticket counters for batch {batch} on this "
                "stream yet; call it once on the capturing stream before the "
                "CUDA-graph capture (a warm-up on that stream)")
        buf = _COUNTERS[key] = torch.zeros(max(batch, 64), dtype=torch.int32,
                                           device=dev)
    return buf


def _launch(x, scale, bias, film_scale, film_shift, num_groups, eps, do_silu):
    """One call of the CUDA kernel (two launches); counted in LAUNCHES."""
    _, _, rows = check_inputs(x, scale, bias, film_scale, film_shift,
                              num_groups=num_groups)

    from diffpir_tpu_torch.kernels.build import load_library

    lib = load_library()
    b, h, w, c = x.shape
    hw = h * w
    dev = x.device
    slices, per = partition_pixels(b, hw)
    stream = current_stream_handle(dev)
    ws = torch.empty(2 * b * (slices + 1) * num_groups,
                     dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    rc = lib.diffpir_groupnorm_silu(
        x.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        None if film_scale is None else film_scale.data_ptr(),
        None if film_shift is None else film_shift.data_ptr(),
        ws.data_ptr(), _counters(dev, stream, b).data_ptr(), b, hw, c,
        num_groups, slices, per, rows, eps, int(do_silu),
        int(x.dtype == torch.bfloat16), stream)
    raise_on_error("groupnorm_silu", rc)
    LAUNCHES["groupnorm_silu"] += 1
    return out


def groupnorm_silu_backward(grad, x, scale, bias, film_scale, film_shift, num_groups,
                            eps, do_silu, needs) -> list:
    """The gradients of ``groupnorm_silu`` for the inputs (x, scale, bias,
    film_scale, film_shift) whose ``needs`` is set (an empty tensor for the
    others): the plain version recomputed and differentiated, so the
    gradient is by construction the plain version's, which the kernel
    matches in the forward.  The backward of both the Function and the
    operator."""
    return recompute_grads(
        lambda *t: groupnorm_silu_plain(*t, num_groups=num_groups, eps=eps,
                                        do_silu=do_silu),
        grad, (x, scale, bias, film_scale, film_shift), needs)


def _some(grads, needs) -> tuple:
    return tuple(g if n else None for g, n in zip(grads, needs))


class GroupNormSiLUFunction(torch.autograd.Function):
    """The kernel's forward with a gradient (``groupnorm_silu_backward``):
    one plain forward per backward, on the paths that ask for one (DPS_y0,
    training, classifier guidance)."""

    @staticmethod
    def forward(ctx, x, scale, bias, film_scale, film_shift, num_groups, eps, do_silu):
        ctx.save_for_backward(x, scale, bias, film_scale, film_shift)
        ctx.args = (num_groups, eps, do_silu)
        return (_launch if x.is_cuda else _plain_call)(x, scale, bias, film_scale,
                                                      film_shift, num_groups, eps, do_silu)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[:5]
        grads = groupnorm_silu_backward(grad_out, *ctx.saved_tensors, *ctx.args, needs)
        return _some(grads, needs) + (None,) * 3


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   film_scale: Optional[torch.Tensor] = None,
                   film_shift: Optional[torch.Tensor] = None, *,
                   num_groups: int = 32, eps: float = 1e-5,
                   do_silu: bool = True) -> torch.Tensor:
    """x: (B, H, W, C) -> GroupNorm(num_groups, fp32 stats) [*(1+fs)+fb] (+SiLU).

    scale, bias: (C,) fp32; film_scale, film_shift: optional (B, C) fp32.
    """
    if emit_operators():
        return _OPS.groupnorm_silu(x, scale, bias, film_scale, film_shift, num_groups,
                                   eps, do_silu)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"groupnorm_silu: unsupported device {x.device}")
    if wants_grad(x, scale, bias, film_scale, film_shift):
        return GroupNormSiLUFunction.apply(x, scale, bias, film_scale, film_shift,
                                           num_groups, eps, do_silu)
    return (_launch if x.is_cuda else _plain_call)(x, scale, bias, film_scale, film_shift,
                                                  num_groups, eps, do_silu)


def _plain_call(x, scale, bias, film_scale, film_shift, num_groups, eps, do_silu):
    return groupnorm_silu_plain(x, scale, bias, film_scale, film_shift,
                                num_groups=num_groups, eps=eps, do_silu=do_silu)


def _groupnorm_silu_fake(x, scale, bias, film_scale, film_shift, num_groups, eps, do_silu):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _grads_fake(grad, tensors, needs) -> list:
    return [torch.empty_like(t) if t is not None and n else grad.new_empty(0)
            for t, n in zip(tensors, needs)]


def _gn_formula(ctx, grad):
    x, scale, bias, fs, fb, g, eps, silu = ctx.inputs
    needs = list(ctx.needs_input_grad[:5])
    grads = _OPS.groupnorm_silu_backward(grad, x, scale, bias, fs, fb, g, eps, silu, needs)
    return _some(grads, needs) + (None,) * 3


define_op("groupnorm_silu_backward(Tensor grad, Tensor x, Tensor scale, Tensor bias, "
          "Tensor? film_scale, Tensor? film_shift, int num_groups, float eps, "
          "bool do_silu, bool[] needs) -> Tensor[]",
          dict.fromkeys(("CPU", "CUDA"), groupnorm_silu_backward),
          lambda grad, x, s, b, fs, fb, g, eps, silu, needs: _grads_fake(
              grad, (x, s, b, fs, fb), needs))
define_op("groupnorm_silu(Tensor x, Tensor scale, Tensor bias, Tensor? film_scale, "
          "Tensor? film_shift, int num_groups, float eps, bool do_silu) -> Tensor",
          {"CPU": _plain_call, "CUDA": _launch},
          _groupnorm_silu_fake, _gn_formula, saved=(0, 1, 2, 3, 4))


# ---------------------------------------------------------------------------
# the two halves, for statistics that span shards
# ---------------------------------------------------------------------------

def groupnorm_partial_stats_plain(x: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """(B, G, 3) fp32 unfinished statistics of ``x``'s pixels per (sample,
    group): bf16 (sum x, sum x^2, n), fp32 (n, mean, M2) with M2 the centred
    sum of squares, as the plain version forms them."""
    b, c = x.shape[0], x.shape[-1]
    g = num_groups
    spatial = tuple(range(1, x.ndim - 1))
    n = float(math.prod(x.shape[1:-1]) * (c // g))
    xf = x.float()
    s1 = xf.sum(dim=spatial).reshape(b, g, c // g).sum(-1)
    nn = torch.full_like(s1, n)
    if x.dtype == torch.float32:
        mean = s1 / n
        mean_full = mean.repeat_interleave(c // g, dim=-1).reshape(
            (b,) + (1,) * (x.ndim - 2) + (c,))
        m2 = (xf - mean_full).square().sum(dim=spatial).reshape(b, g, c // g).sum(-1)
        return torch.stack([nn, mean, m2], dim=-1)
    s2 = xf.square().sum(dim=spatial).reshape(b, g, c // g).sum(-1)
    return torch.stack([s1, s2, nn], dim=-1)


def merge_partial_stats(parts: torch.Tensor, is_bf16: bool,
                        eps: float = 1e-5) -> torch.Tensor:
    """(R, B, G, 3) partial statistics of R shards -> (B, G, 2) (mean, rstd),
    joined in shard order: bf16 by sums, fp32 by Chan's formula, as the
    kernel joins its pixel segments.  No atomics: reruns are
    bit-identical, and one shard gives the unsharded plain version's values.
    Host-side PyTorch operations on both devices; in a recorded program the
    operator ``groupnorm_merge_stats`` (its ``rsqrt`` is no plain GroupNorm)."""
    if emit_operators():
        return _OPS.groupnorm_merge_stats(parts, is_bf16, eps)
    return _merge_plain(parts, is_bf16, eps)


def _merge_plain(parts: torch.Tensor, is_bf16: bool, eps: float = 1e-5) -> torch.Tensor:
    """``merge_partial_stats`` in PyTorch operations."""
    if is_bf16:
        s1, s2, n = parts[0].unbind(-1)
        for p in parts[1:]:
            a1, a2, an = p.unbind(-1)
            s1, s2, n = s1 + a1, s2 + a2, n + an
        mean = s1 / n
        var = (s2 / n - mean.square()).clamp_min(0.0)
    else:
        n, mean, m2 = parts[0].unbind(-1)
        for p in parts[1:]:
            nb, mb, m2b = p.unbind(-1)
            nt = n + nb
            d = mb - mean
            mean = mean + d * (nb / nt)
            m2 = m2 + m2b + d * d * (n * nb / nt)
            n = nt
        var = m2 / n
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=-1)


def groupnorm_apply_stats_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                stats: torch.Tensor,
                                film_scale: Optional[torch.Tensor] = None,
                                film_shift: Optional[torch.Tensor] = None, *,
                                do_silu: bool = True) -> torch.Tensor:
    """``groupnorm_silu_plain``'s affine, FiLM and SiLU from given (B, G, 2)
    (mean, rstd)."""
    dtype = x.dtype
    b, c = x.shape[0], x.shape[-1]
    g = stats.shape[1]
    bshape = (b,) + (1,) * (x.ndim - 2) + (c,)
    mean, inv = stats[..., 0], stats[..., 1]
    w = inv.repeat_interleave(c // g, dim=-1) * scale.float()[None]
    off = bias.float()[None] - mean.repeat_interleave(c // g, dim=-1) * w
    if film_scale is not None:
        f = 1.0 + film_scale.float()
        w = w * f
        off = off * f + film_shift.float()
    y = x.float() * w.reshape(bshape) + off.reshape(bshape)
    if do_silu:
        y = F.silu(y)
    return y.to(dtype)


class PartialPlan(NamedTuple):
    """How the partial-statistics launch cuts a (B, H, W, C) tensor
    (``csrc/groupnorm_partial.cu``): ``chunks`` channel chunks of whole
    groups, ``segments`` pixel segments, one block each (more than one:
    their pairs are merged by a second launch); ``rows`` pixel rows a
    block."""
    chunks: int
    rows: int
    segments: int = 1


def partial_plan(batch: int, hw: int, c: int, itemsize: int,
                 num_groups: int = 32) -> PartialPlan:
    """The plan of the partial-statistics launch for one shape, from the
    sweeps of ``scripts/gn_partial_probe.py`` on the H100 (``PERF.md`` §6):
    as many channel chunks as the groups and 16-byte vectors allow (chunks
    of whole 32-byte sectors from ``_PARTIAL_ALIGN_BYTES`` on); one block a
    (sample, chunk) of ``_PARTIAL_SMALL_THREADS`` threads in bf16 and twice
    that in fp32 where a (sample, chunk) holds at most
    ``_PARTIAL_SINGLE_ELEMS`` elements, which then ends with its own
    reduction; above that, pixel segments of about 256 threads up to
    ``_PARTIAL_BLOCKS`` blocks (twice as many from ``_PARTIAL_ALIGN_BYTES``
    on), merged by a second launch, with chunks of whole sectors where that
    leaves four chunks or more."""
    vec = 16 // itemsize
    if c % vec:
        raise ValueError(f"groupnorm_partial_stats: C={c} is not a multiple of {vec} "
                         f"(16-byte vectors of {itemsize}-byte elements)")
    large = batch * hw * c * itemsize >= _PARTIAL_ALIGN_BYTES
    chunks = 1
    for k in (8, 4, 2):
        cc = c // k
        if (num_groups % k == 0 and c % k == 0 and cc % vec == 0
                and (not large or (cc * itemsize) % 32 == 0)):
            chunks = k
            break
    nv = c // chunks // vec
    if nv > 512:
        raise ValueError(f"groupnorm_partial_stats: C={c} is too wide for one block")
    if hw * (c // chunks) <= _PARTIAL_SINGLE_ELEMS:
        return PartialPlan(chunks, max(1, min(_PARTIAL_SMALL_THREADS * 8 // vec // nv, hw)))
    if chunks >= 8 and (c // chunks * itemsize) % 32 and (c // chunks * 2 * itemsize) % 32 == 0:
        chunks //= 2
        nv *= 2
    blocks = _PARTIAL_BLOCKS * (2 if large else 1)
    segments = max(2, min(32, blocks // (batch * chunks), hw))
    rows = max(1, min(256 // nv, -(-hw // segments)))
    return PartialPlan(chunks, rows, segments)


def _launch_partial(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """One launch of the partial-statistics kernel, counted in LAUNCHES, and
    with several pixel segments one of its merge, counted under
    ``groupnorm_partial_merge``."""
    _check_x(x, num_groups)

    from diffpir_tpu_torch.kernels.build import load_library

    lib = load_library()
    b, h, w, c = x.shape
    plan = partial_plan(b, h * w, c, x.element_size(), num_groups)
    dev = x.device
    out = torch.empty((b, num_groups, 3), dtype=torch.float32, device=dev)
    ws = (torch.empty(2 * b * plan.segments * num_groups, dtype=torch.float32, device=dev)
          if plan.segments > 1 else None)
    rc = lib.diffpir_groupnorm_partial_stats(
        x.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(), b, h * w, c,
        num_groups, plan.chunks, plan.segments, plan.rows,
        int(x.dtype == torch.bfloat16), current_stream_handle(dev))
    raise_on_error("groupnorm_partial_stats", rc)
    LAUNCHES["groupnorm_partial_stats"] += 1
    if plan.segments > 1:
        LAUNCHES["groupnorm_partial_merge"] += 1
    return out


def _launch_apply(x, scale, bias, stats, film_scale, film_shift, do_silu):
    """One launch of the apply kernel; counted in LAUNCHES."""
    g = stats.shape[1]
    _, _, rows = check_inputs(x, scale, bias, film_scale, film_shift, num_groups=g)
    check_cuda_tensor("stats", stats, x.device, (torch.float32,), (x.shape[0], g, 2))

    from diffpir_tpu_torch.kernels.build import load_library

    lib = load_library()
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    rc = lib.diffpir_groupnorm_apply_stats(
        x.data_ptr(), out.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        None if film_scale is None else film_scale.data_ptr(),
        None if film_shift is None else film_shift.data_ptr(), stats.data_ptr(),
        b, h * w, c, g, rows, int(do_silu), int(x.dtype == torch.bfloat16),
        current_stream_handle(x.device))
    raise_on_error("groupnorm_apply_stats", rc)
    LAUNCHES["groupnorm_apply_stats"] += 1
    return out


def partial_stats_backward(grad, x, num_groups):
    """The gradient of ``groupnorm_partial_stats`` for x (plain recompute)."""
    return recompute_grads(groupnorm_partial_stats_plain, grad, (x,), (True,),
                           num_groups)[0]


def apply_stats_backward(grad, x, scale, bias, stats, film_scale, film_shift, do_silu,
                         needs) -> list:
    """The gradients of ``groupnorm_apply_stats`` for the inputs (x, scale,
    bias, stats, film_scale, film_shift) whose ``needs`` is set (plain
    recompute): the stats' gradient carries the other rows' share of x's."""
    return recompute_grads(
        lambda *t: groupnorm_apply_stats_plain(*t, do_silu=do_silu),
        grad, (x, scale, bias, stats, film_scale, film_shift), needs)


def merge_stats_backward(grad, parts, is_bf16, eps):
    return recompute_grads(_merge_plain, grad, (parts,), (True,), is_bf16, eps)[0]


class PartialStatsFunction(torch.autograd.Function):
    """The partial-statistics kernel with a gradient for x."""

    @staticmethod
    def forward(ctx, x, num_groups):
        ctx.save_for_backward(x)
        ctx.num_groups = num_groups
        return (_launch_partial if x.is_cuda else groupnorm_partial_stats_plain)(
            x, num_groups)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return partial_stats_backward(grad, x, ctx.num_groups), None


class ApplyStatsFunction(torch.autograd.Function):
    """The apply kernel with gradients for its tensors."""

    @staticmethod
    def forward(ctx, x, scale, bias, stats, film_scale, film_shift, do_silu):
        ctx.save_for_backward(x, scale, bias, stats, film_scale, film_shift)
        ctx.do_silu = do_silu
        return (_launch_apply if x.is_cuda else _apply_plain_call)(
            x, scale, bias, stats, film_scale, film_shift, do_silu)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[:6]
        grads = apply_stats_backward(grad, *ctx.saved_tensors, ctx.do_silu, needs)
        return _some(grads, needs) + (None,)


def groupnorm_partial_stats(x: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, G, 3) fp32 partial statistics
    (``groupnorm_partial_stats_plain``); one kernel launch on the card."""
    if emit_operators():
        return _OPS.groupnorm_partial_stats(x, num_groups)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"groupnorm_partial_stats: unsupported device {x.device}")
    if wants_grad(x):
        return PartialStatsFunction.apply(x, num_groups)
    return (_launch_partial if x.is_cuda else groupnorm_partial_stats_plain)(
        x, num_groups)


def groupnorm_apply_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          stats: torch.Tensor,
                          film_scale: Optional[torch.Tensor] = None,
                          film_shift: Optional[torch.Tensor] = None, *,
                          do_silu: bool = True) -> torch.Tensor:
    """x normalised with (B, G, 2) fp32 (mean, rstd), then the affine step,
    optional FiLM and SiLU (``groupnorm_apply_stats_plain``); one kernel
    launch on the card."""
    if emit_operators():
        return _OPS.groupnorm_apply_stats(x, scale, bias, stats, film_scale, film_shift,
                                          do_silu)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"groupnorm_apply_stats: unsupported device {x.device}")
    if wants_grad(x, scale, bias, stats, film_scale, film_shift):
        return ApplyStatsFunction.apply(x, scale, bias, stats, film_scale, film_shift,
                                        do_silu)
    return (_launch_apply if x.is_cuda else _apply_plain_call)(
        x, scale, bias, stats, film_scale, film_shift, do_silu)


def _apply_plain_call(x, scale, bias, stats, film_scale, film_shift, do_silu):
    return groupnorm_apply_stats_plain(x, scale, bias, stats, film_scale, film_shift,
                                       do_silu=do_silu)


def _partial_formula(ctx, grad):
    x, g = ctx.inputs
    return _OPS.groupnorm_partial_stats_backward(grad, x, g), None


def _apply_formula(ctx, grad):
    x, scale, bias, stats, fs, fb, silu = ctx.inputs
    needs = list(ctx.needs_input_grad[:6])
    grads = _OPS.groupnorm_apply_stats_backward(grad, x, scale, bias, stats, fs, fb,
                                                silu, needs)
    return _some(grads, needs) + (None,)


def _merge_formula(ctx, grad):
    parts, is_bf16, eps = ctx.inputs
    return _OPS.groupnorm_merge_stats_backward(grad, parts, is_bf16, eps), None, None


def _partial_fake(x, num_groups):
    return x.new_empty((x.shape[0], num_groups, 3), dtype=torch.float32)


def _merge_fake(parts, is_bf16, eps):
    return parts.new_empty(tuple(parts.shape[1:3]) + (2,))


define_op("groupnorm_partial_stats_backward(Tensor grad, Tensor x, int num_groups) "
          "-> Tensor", dict.fromkeys(("CPU", "CUDA"), partial_stats_backward),
          lambda grad, x, g: torch.empty_like(x))
define_op("groupnorm_partial_stats(Tensor x, int num_groups) -> Tensor",
          {"CPU": groupnorm_partial_stats_plain, "CUDA": _launch_partial},
          _partial_fake, _partial_formula, saved=(0,))
define_op("groupnorm_apply_stats_backward(Tensor grad, Tensor x, Tensor scale, "
          "Tensor bias, Tensor stats, Tensor? film_scale, Tensor? film_shift, "
          "bool do_silu, bool[] needs) -> Tensor[]",
          dict.fromkeys(("CPU", "CUDA"), apply_stats_backward),
          lambda grad, x, s, b, st, fs, fb, silu, needs: _grads_fake(
              grad, (x, s, b, st, fs, fb), needs))
define_op("groupnorm_apply_stats(Tensor x, Tensor scale, Tensor bias, Tensor stats, "
          "Tensor? film_scale, Tensor? film_shift, bool do_silu) -> Tensor",
          {"CPU": _apply_plain_call, "CUDA": _launch_apply},
          lambda x, s, b, st, fs, fb, silu: torch.empty_like(
              x, memory_format=torch.contiguous_format),
          _apply_formula, saved=(0, 1, 2, 3, 4, 5))
define_op("groupnorm_merge_stats_backward(Tensor grad, Tensor parts, bool is_bf16, "
          "float eps) -> Tensor", dict.fromkeys(("CPU", "CUDA"), merge_stats_backward),
          lambda grad, parts, is_bf16, eps: torch.empty_like(parts))
define_op("groupnorm_merge_stats(Tensor parts, bool is_bf16, float eps) -> Tensor",
          dict.fromkeys(("CPU", "CUDA"), _merge_plain), _merge_fake, _merge_formula,
          saved=(0,))
