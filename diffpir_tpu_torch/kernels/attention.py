"""Self-attention in the legacy guided-diffusion QKV layout.

Port of the TPU kernel ``diffpir_tpu/pallas/attention.py::legacy_qkv_attention``
(defined at ``:47``, ``pl.pallas_call`` at ``:62``, body ``_attn_kernel`` at
``:32-43``) to the CUDA kernel
in ``csrc/attention.cu``.  qkv is (B, T, 3*C) with channel layout
[head][q|k|v][ch]; q and k are both scaled by ch^-1/4; logits and softmax are
fp32; the output is (B, T, C).

``legacy_qkv_attention`` runs the plain version for a CPU tensor and the CUDA
kernel for a CUDA tensor; it never falls back from one to the other.
"""

from __future__ import annotations

import math

import torch

from diffpir_tpu_torch.kernels import LAUNCHES
from diffpir_tpu_torch.kernels._common import (check_cuda_tensor,
                                               current_stream_handle,
                                               raise_on_error)

__all__ = ["legacy_qkv_attention", "legacy_qkv_attention_plain"]

KERNEL_HEAD_CHANNELS = (32, 64)


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


def legacy_qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """qkv: (B, T, 3*C) with layout [head][q|k|v][head_dim] -> (B, T, C)."""
    if qkv.device.type == "cpu":
        return legacy_qkv_attention_plain(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"legacy_qkv_attention: unsupported device {qkv.device}")
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"legacy_qkv_attention takes (B, T, 3*heads*ch), got "
                         f"{tuple(qkv.shape)} with {num_heads} heads")
    b, t, w = qkv.shape
    ch = w // (3 * num_heads)
    if ch not in KERNEL_HEAD_CHANNELS:
        raise ValueError(f"legacy_qkv_attention: head width {ch} not in "
                         f"{KERNEL_HEAD_CHANNELS}")
    if b * num_heads > 65535:
        raise ValueError("legacy_qkv_attention: batch*heads exceeds 65535")
    check_cuda_tensor("qkv", qkv, qkv.device)

    from diffpir_tpu_torch.kernels.build import load_library

    lib = load_library()
    out = torch.empty((b, t, num_heads * ch), dtype=qkv.dtype, device=qkv.device)
    rc = lib.diffpir_legacy_qkv_attention(
        qkv.data_ptr(), out.data_ptr(), b, t, num_heads, ch,
        int(qkv.dtype == torch.bfloat16), current_stream_handle(qkv.device))
    raise_on_error("legacy_qkv_attention", rc)
    LAUNCHES["legacy_qkv_attention"] += 1
    return out
