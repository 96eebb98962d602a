"""Self-attention in the legacy guided-diffusion QKV layout.

Port of the TPU kernel ``diffpir_tpu/pallas/attention.py::legacy_qkv_attention``
(defined at ``:47``, ``pl.pallas_call`` at ``:62``, body ``_attn_kernel`` at
``:32-43``) to the CUDA kernel
in ``csrc/attention.cu`` (bf16 on tensor cores, fp32 on CUDA cores; tuned
kernels for head widths 16, 32 and 64, kernels taking every other width up
to 256, and one taking any wider head through shared memory in chunks, with
its logits in a workspace this wrapper allocates).  Any number of
(batch, head) pairs is taken.  qkv is
(B, T, 3*C) with channel layout [head][q|k|v][ch]; q and k are both scaled by
ch^-1/4; logits and softmax are fp32; the output is (B, T, C).

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
           "attention_rows_per_block", "check_inputs"]

# head widths the kernel takes: tuned paths run 16, 32 and 64, the other
# widths' kernels the rest up to WIDE_HEAD_CHANNELS, attn_wide every wider one
KERNEL_HEAD_CHANNELS = range(1, sys.maxsize)
WIDE_HEAD_CHANNELS = 256
# query tiles the kernel takes, largest first: bf16 warps own 16 rows (tiles
# of 16, 32) or 32 rows (64, 128); fp32 warps own 8 rows, at most 256 threads
ROWS_PER_BLOCK = {True: (128, 64, 32, 16), False: (64, 32, 16)}
# attn_wide: 16 query rows per work item, each block's logits in the
# workspace (16 * T floats), at most WIDE_BLOCKS blocks or WIDE_WS_BYTES
WIDE_ROWS = 16
WIDE_BLOCKS = 1056
WIDE_WS_BYTES = 256 << 20


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


def wide_blocks(batch: int, t: int, heads: int) -> int:
    """Blocks of attn_wide: one per (pair, 16-row query tile), at most
    ``WIDE_BLOCKS`` and as many as ``WIDE_WS_BYTES`` of workspace hold."""
    items = batch * heads * -(-t // WIDE_ROWS)
    budget = max(1, WIDE_WS_BYTES // (WIDE_ROWS * t * 4))
    return min(items, WIDE_BLOCKS, budget)


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
    # the tuned widths' query tile (the other widths' kernels ignore it)
    rows = attention_rows_per_block(b, t, num_heads, is_bf16, _num_sms(qkv.device.index))
    ws, blocks = None, 0
    if ch > WIDE_HEAD_CHANNELS or num_heads > 65535:
        blocks = wide_blocks(b, t, num_heads)
        ws = torch.empty(blocks * WIDE_ROWS * t, dtype=torch.float32, device=qkv.device)
    rc = lib.diffpir_legacy_qkv_attention(
        qkv.data_ptr(), out.data_ptr(), b, t, num_heads, ch, rows, int(is_bf16),
        None if ws is None else ws.data_ptr(), blocks,
        current_stream_handle(qkv.device))
    raise_on_error("legacy_qkv_attention", rc)
    LAUNCHES["legacy_qkv_attention"] += 1
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
