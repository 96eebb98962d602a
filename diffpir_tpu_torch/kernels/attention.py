"""Self-attention in the legacy guided-diffusion QKV layout.

Port of the TPU kernel ``diffpir_tpu/pallas/attention.py::legacy_qkv_attention``
(defined at ``:47``, ``pl.pallas_call`` at ``:62``, body ``_attn_kernel`` at
``:32-43``) to the CUDA kernels in ``csrc/attention.cu``.  qkv is (B, T, 3*C)
with channel layout [head][q|k|v][ch]; q and k are both scaled by ch^-1/4;
logits and softmax are fp32; the output is (B, T, C).  Any head width and any
number of (batch, head) pairs is taken.

``attention_plan`` is the one place that decides how a call runs: its
variant (``attention_variant``: "tuned" at widths 16, 32 and 64; "bf16_any",
wgmma fed by TMA, for every other bf16 width and head count; "f32_any",
split-TF32 products on tensor cores, for every other fp32 width up to 256
and head count; "f32_wide" beyond), the query rows of a block and the
output slices.  The C entry receives it.
``VARIANT_LAUNCHES`` counts the launches by variant.

``legacy_qkv_attention`` runs the plain version for a CPU tensor and the CUDA
kernel for a CUDA tensor; it never falls back from one to the other.  Where a
gradient is asked for (grad mode on and qkv requires one), the launch (on
the CPU the plain version) runs inside ``LegacyQKVAttentionFunction``, whose
backward recomputes the plain version and differentiates it (the TPU kernel
has no backward kernel to port, and the kernel stays forward-only).

The same function is the operator
``torch.ops.diffpir_tpu_torch.legacy_qkv_attention`` (``_common.define_op``;
CPU: the plain version; CUDA: ``_launch``; a fake one for the shapes), with
an autograd formula that calls ``::legacy_qkv_attention_backward`` (the same
recompute, on both keys).  While a program is recorded (a ``torch.export``
trace, ``_common.operators()``) the wrapper emits the operator; an eager
call keeps the direct path.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import sys

import torch

from diffpir_tpu_torch.kernels import LAUNCHES
from diffpir_tpu_torch.kernels._common import (check_aligned,
                                               check_cuda_tensor,
                                               current_stream_handle, define_op,
                                               emit_operators, raise_on_error,
                                               recompute_grads, wants_grad)

__all__ = ["legacy_qkv_attention", "legacy_qkv_attention_plain",
           "LegacyQKVAttentionFunction", "legacy_qkv_attention_backward",
           "attention_rows_per_block", "attention_variant", "attention_plan",
           "AttentionPlan", "VARIANT_LAUNCHES", "check_inputs", "f32_any_smem",
           "f32_any_group_rows"]

# head widths the kernel takes: every one (attention_variant names the kernel)
KERNEL_HEAD_CHANNELS = range(1, sys.maxsize)
# the tuned kernels' widths; they take (batch, head) pairs on grid y, so a
# sample may have at most MAX_GRID_Y heads (more pairs run as launches over
# whole samples)
TUNED_HEAD_CHANNELS = (16, 32, 64)
MAX_GRID_Y = 65535
# attn_f32_any takes fp32 widths up to F32_ANY_MAX_CH and any head count
F32_ANY_MAX_CH = 256
# the other kernels put (pair, query tile[, slice]) on grid x
MAX_GRID_X = 2**31 - 1
# dynamic shared memory a block may have on the card
MAX_SMEM = 232448
# the C entry's variant numbers
VARIANTS = {"tuned": 0, "bf16_any": 1, "f32_any": 2, "f32_wide": 3}
# query tiles the tuned kernels take, largest first: bf16 warps own 16 rows
# (tiles of 16, 32) or 32 rows (64, 128); fp32 warps own 8 rows, at most 256
# threads
ROWS_PER_BLOCK = {True: (128, 64, 32, 16), False: (64, 32, 16)}
# query rows per block of the other variants: attn_bf16_any takes one or two
# warpgroups of 64 rows, two up to BF16_ANY_TWO_WG_MAX_CH channels (where
# their Q fits in shared memory beside the ring)
BF16_ANY_ROWS = (128, 64)
BF16_ANY_TWO_WG_MAX_CH = 384
VARIANT_ROWS = {"f32_wide": 16}
# attn_f32_any: blocks of eight warps as (row groups, warps a row group
# splitting each tile's keys), most rows first; a row group is 32 query rows
# up to 128 channels (two m-tiles a warp), 16 beyond; a warp takes
# F32_ANY_WARP_KEYS keys of a tile
F32_ANY_SHAPES = ((8, 1), (4, 2), (2, 4))
# ... and a block of four warps, two row groups of 16 rows (above 128
# channels) times two key splits, where eight warps a block would leave half
# the SMs idle
F32_ANY_NARROW = (2, 2)
F32_ANY_WARP_KEYS = 16
# its instantiations: n-tiles of 8 channels each holds
F32_ANY_TILES = (1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24, 32)
# blocks a query tile at most, each a share of the key tiles, where the grid
# would leave half the SMs idle and the keys span F32_ANY_CHUNK_MIN_TILES
# tiles or more (their partial sums merged by a second launch)
F32_ANY_MAX_CHUNKS = 8
F32_ANY_CHUNK_MIN_TILES = 3
# output channels a block of attn_bf16_any keeps in registers (its
# instantiations), and at most a block of attn_wide does (its two)
BF16_SLICE_CHANNELS = (32, 64, 96, 128, 192, 256)
WIDE_SLICE_CHANNELS = (256, 512)
# launches by variant (LAUNCHES counts them all under legacy_qkv_attention);
# callers reset it with VARIANT_LAUNCHES.clear()
VARIANT_LAUNCHES: collections.Counter = collections.Counter()


def attention_variant(is_bf16: bool, ch: int, heads: int) -> str:
    """The kernel that takes a head width and a head count: "tuned" (ch 16,
    32 or 64, at most MAX_GRID_Y heads), else "bf16_any" in bf16, "f32_any"
    in fp32 up to 256 channels, "f32_wide" beyond."""
    if ch in TUNED_HEAD_CHANNELS and heads <= MAX_GRID_Y:
        return "tuned"
    if is_bf16:
        return "bf16_any"
    if ch <= F32_ANY_MAX_CH:
        return "f32_any"
    return "f32_wide"


def f32_any_group_rows(ch: int) -> int:
    """Query rows of an attn_f32_any row group (csrc/attention.cu
    f32_any_mtiles): 32 up to 128 channels, else 16."""
    return 32 if ch <= 128 else 16


def f32_any_smem(ch: int, rows: int, splits: int) -> int:
    """Dynamic shared memory of attn_f32_any (csrc/attention.cu
    f32_any_smem): Q's rows and two K/V tiles of F32_ANY_WARP_KEYS * splits
    keys, rows of the instantiation's width (F32_ANY_TILES n-tiles of 8
    channels) plus 4 floats; or, if more, the key-split warps' (m, l, O)
    for the merge."""
    nt = next(n for n in F32_ANY_TILES if 8 * n >= ch)
    tiles = (8 * nt + 4) * (rows + 4 * F32_ANY_WARP_KEYS * splits)
    merge = (splits - 1) * (rows // 16) * 32 * (4 * nt + 4)
    return 4 * max(tiles, merge)


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    variant: str   # attention_variant
    rows: int      # query rows per block
    slice_ch: int  # output channels per block
    slices: int    # blocks per (pair, query tile)
    blocks: int    # blocks over every launch of the call
    key_splits: int = 1  # warps of attn_f32_any sharing a row group
    kv_chunks: int = 1   # blocks of attn_f32_any sharing a query tile's keys


def attention_plan(batch: int, t: int, heads: int, ch: int, is_bf16: bool,
                   num_sms: int = 132) -> AttentionPlan:
    """How a call is launched.  attn_f32_any takes 8, 4 or 2 row groups
    (f32_any_group_rows) a block, its eight warps in one, two or four splits
    of the keys: the most rows whose grid still gives every SM a block;
    above 128 channels, where that grid leaves half the SMs idle, blocks of
    four warps (F32_ANY_NARROW); where the grid still leaves half the SMs
    idle, each query tile's keys are cut into up to F32_ANY_MAX_CHUNKS
    chunks, a block each.  attn_bf16_any cuts a head wider than 256 into
    ceil(ch / 256) slices, each of the smallest instantiation that
    holds its share, and into more (down to 64 channels) while the grid
    would leave most SMs idle; attn_wide into equal slices of up to 512
    channels, or 256 where the grid would be small.  Raises when the sliced
    kernels' grid would pass MAX_GRID_X."""
    variant = attention_variant(is_bf16, ch, heads)
    splits = chunks = 1
    if variant == "tuned":
        rows, slice_ch = attention_rows_per_block(batch, t, heads, is_bf16, num_sms), ch
    elif variant == "f32_any":
        # the most query rows whose grid still gives every SM a block, the
        # block's other warps splitting the keys; else the fewest rows
        gr = f32_any_group_rows(ch)
        fits = [(gr * g, k) for g, k in F32_ANY_SHAPES
                if f32_any_smem(ch, gr * g, k) <= MAX_SMEM]
        rows, splits = next((s for s in fits if batch * heads * -(-t // s[0]) >= num_sms),
                            fits[-1])
        narrow = (gr * F32_ANY_NARROW[0], F32_ANY_NARROW[1])
        if (gr == 16 and narrow[0] < rows and 2 * batch * heads * -(-t // rows) <= num_sms
                and f32_any_smem(ch, *narrow) <= MAX_SMEM):
            rows, splits = narrow
        # and where that grid would still leave half the SMs idle, the keys
        # in chunks of at least one tile
        tiles = batch * heads * -(-t // rows)
        key_tiles = -(-t // (F32_ANY_WARP_KEYS * splits))
        if 2 * tiles <= num_sms and key_tiles >= F32_ANY_CHUNK_MIN_TILES:
            chunks = min(F32_ANY_MAX_CHUNKS, num_sms // tiles, key_tiles)
        slice_ch = ch
    elif variant == "f32_wide":
        # slices of up to 512 channels (S computed once for each) where the
        # grid still fills the card twice over, else up to 256; equal shares
        # in multiples of 64
        rows = VARIANT_ROWS[variant]
        n = -(-ch // WIDE_SLICE_CHANNELS[1])
        if batch * heads * -(-t // rows) * n * 2 < num_sms:
            n = -(-ch // WIDE_SLICE_CHANNELS[0])
        share = -(-ch // n)
        slice_ch = -(-share // 64) * 64
    else:
        # two warpgroups share K and V where Q stays in shared memory and the
        # grid still gives every SM a block; else one, and where the blocks
        # would leave most SMs idle, narrower slices (S recomputed for each)
        n = -(-ch // BF16_SLICE_CHANNELS[-1])
        two = (ch <= BF16_ANY_TWO_WG_MAX_CH
               and batch * heads * -(-t // BF16_ANY_ROWS[0]) * n >= num_sms)
        rows = BF16_ANY_ROWS[0 if two else 1]
        if not two:
            base = batch * heads * -(-t // rows)
            while base * 2 * n <= num_sms and 2 * n <= -(-ch // 64):
                n *= 2
        share = -(-ch // n)
        slice_ch = next(w for w in BF16_SLICE_CHANNELS if w >= share)
    slices = -(-ch // slice_ch)
    blocks = batch * heads * -(-t // rows) * slices * chunks
    if variant != "tuned" and blocks > MAX_GRID_X:
        raise ValueError(f"legacy_qkv_attention: ({batch}, {t}, {heads} x {ch}) needs "
                         f"{blocks} blocks, more than a grid holds ({MAX_GRID_X})")
    return AttentionPlan(variant, rows, slice_ch, slices, blocks, splits, chunks)


def attention_rows_per_block(batch: int, t: int, heads: int, is_bf16: bool,
                             num_sms: int = 132) -> int:
    """Query rows per block: the largest tile whose grid still gives every
    SM a block, else the smallest (few batch*head pairs at short T)."""
    pairs = batch * heads
    tiles = ROWS_PER_BLOCK[is_bf16]
    for rows in tiles:
        if pairs * -(-t // rows) >= num_sms:
            return rows
    return tiles[-1]


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def legacy_qkv_attention_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The same function in PyTorch operations, as
    ``diffpir_tpu/models/unet.py::_legacy_qkv_attention`` computes it (the
    weights are cast to the input type before P.V)."""
    b, t, w = qkv.shape
    ch = w // (3 * num_heads)
    qkv = qkv.reshape(b, t, num_heads, 3, ch)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
    weights = torch.softmax(logits.float(), dim=-1).to(qkv.dtype)
    out = torch.einsum("bhts,bshc->bthc", weights, v)
    return out.reshape(b, t, num_heads * ch)


def check_inputs(qkv: torch.Tensor, num_heads: int) -> int:
    """Raise unless the kernel takes ``qkv`` with ``num_heads`` heads
    (shape, type, contiguity, 16-byte alignment); returns the head width."""
    if (qkv.ndim != 3 or num_heads < 1 or qkv.shape[-1] % (3 * num_heads)
            or qkv.shape[-1] == 0):
        raise ValueError(f"legacy_qkv_attention takes (B, T, 3*heads*ch), got "
                         f"{tuple(qkv.shape)} with {num_heads} heads")
    ch = qkv.shape[-1] // (3 * num_heads)
    check_cuda_tensor("qkv", qkv, qkv.device)
    check_aligned("qkv", qkv)
    return ch


def _launch(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """One launch of the CUDA kernel; counted in LAUNCHES."""
    ch = check_inputs(qkv, num_heads)
    b, t, _ = qkv.shape

    from diffpir_tpu_torch.kernels.build import load_library

    lib = load_library()
    out = torch.empty((b, t, num_heads * ch), dtype=qkv.dtype, device=qkv.device)
    is_bf16 = qkv.dtype == torch.bfloat16
    plan = attention_plan(b, t, num_heads, ch, is_bf16, _num_sms(qkv.device.index))
    # attn_f32_any's partial sums of its key chunks: O, then (max, sum) per row
    work = (torch.empty(b * num_heads * t * plan.kv_chunks * (ch + 2), dtype=torch.float32,
                        device=qkv.device) if plan.kv_chunks > 1 else None)
    rc = lib.diffpir_legacy_qkv_attention(
        qkv.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(), b, t,
        num_heads, ch, VARIANTS[plan.variant], plan.rows, plan.slice_ch, plan.key_splits,
        plan.kv_chunks, int(is_bf16), current_stream_handle(qkv.device))
    raise_on_error("legacy_qkv_attention", rc)
    LAUNCHES["legacy_qkv_attention"] += 1
    VARIANT_LAUNCHES[plan.variant] += 1
    return out


def legacy_qkv_attention_backward(grad: torch.Tensor, qkv: torch.Tensor,
                                  num_heads: int) -> torch.Tensor:
    """The gradient of ``legacy_qkv_attention`` for qkv: the plain version
    recomputed and differentiated, so it is by construction the plain
    version's.  The backward of both the Function and the operator."""
    return recompute_grads(legacy_qkv_attention_plain, grad, (qkv,), (True,),
                           num_heads)[0]


class LegacyQKVAttentionFunction(torch.autograd.Function):
    """The kernel's forward with a gradient for qkv
    (``legacy_qkv_attention_backward``: one plain forward per backward, on
    the paths that ask for one)."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return (_launch if qkv.is_cuda else legacy_qkv_attention_plain)(qkv, num_heads)

    @staticmethod
    def backward(ctx, grad_out):
        (qkv,) = ctx.saved_tensors
        return legacy_qkv_attention_backward(grad_out, qkv, ctx.num_heads), None


def legacy_qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """qkv: (B, T, 3*C) with layout [head][q|k|v][head_dim] -> (B, T, C)."""
    if emit_operators():
        return torch.ops.diffpir_tpu_torch.legacy_qkv_attention(qkv, num_heads)
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"legacy_qkv_attention: unsupported device {qkv.device}")
    if wants_grad(qkv):
        return LegacyQKVAttentionFunction.apply(qkv, num_heads)
    return (_launch if qkv.is_cuda else legacy_qkv_attention_plain)(qkv, num_heads)


def _legacy_qkv_attention_fake(qkv, num_heads):
    b, t, w = qkv.shape
    return qkv.new_empty((b, t, w // 3))


def _attention_formula(ctx, grad):
    qkv, heads = ctx.inputs
    return torch.ops.diffpir_tpu_torch.legacy_qkv_attention_backward(grad, qkv, heads), None


define_op("legacy_qkv_attention_backward(Tensor grad, Tensor qkv, int num_heads) -> Tensor",
          dict.fromkeys(("CPU", "CUDA"), legacy_qkv_attention_backward),
          lambda grad, qkv, num_heads: torch.empty_like(qkv))
define_op("legacy_qkv_attention(Tensor qkv, int num_heads) -> Tensor",
          {"CPU": legacy_qkv_attention_plain, "CUDA": _launch},
          _legacy_qkv_attention_fake, _attention_formula, saved=(0,))
