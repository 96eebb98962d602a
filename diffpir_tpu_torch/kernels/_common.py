"""Argument checks shared by the kernel wrappers, and the port's operators."""

from __future__ import annotations

from typing import Callable

import torch

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)

# the namespace of the port's operators, torch.ops.diffpir_tpu_torch.*
OPS_NAMESPACE = "diffpir_tpu_torch"
_LIB = torch.library.Library(OPS_NAMESPACE, "FRAGMENT")
# (operator name, dispatch key) -> the implementation define_op registered
OP_IMPLS: dict[tuple[str, str], Callable] = {}


def define_op(schema: str, impls: dict[str, Callable], fake: Callable) -> None:
    """Define the operator ``torch.ops.diffpir_tpu_torch.<name>`` from its
    schema, one implementation per dispatch key (``"CPU"``, ``"CUDA"``) and
    a fake implementation that gives the output's shape and type (what a
    ``torch.export`` trace runs).  Registered directly with the dispatcher:
    ``torch.library.custom_op`` wraps each call in Python layers (autograd,
    aliasing checks) that on the card's host cost about as much again as the
    kernel's own wrapper (PERF.md §6, PR 12).  No autograd formula: the
    programs that call these operators run without gradients."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    for key, fn in impls.items():
        _LIB.impl(name, fn, key)
        OP_IMPLS[(name, key)] = fn
    torch.library.register_fake(f"{OPS_NAMESPACE}::{name}", fake, lib=_LIB)


def check_cuda_tensor(name: str, t: torch.Tensor, device: torch.device,
                      dtypes=SUPPORTED_DTYPES, shape=None) -> None:
    """Raise unless ``t`` is a contiguous tensor of an accepted type and
    shape on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(name: str, t: torch.Tensor, alignment: int = 16) -> None:
    """Raise unless ``t``'s data starts on an ``alignment``-byte boundary (the
    kernels read and write 16-byte vectors); an offset view can fail this."""
    if t.data_ptr() % alignment:
        raise ValueError(f"{name} must start on a {alignment}-byte boundary "
                         f"(storage offset {t.storage_offset()} elements)")


def wants_grad(*tensors) -> bool:
    """Whether a wrapper must run its kernel inside its autograd.Function:
    grad mode is on and an input (None allowed) requires a gradient.  The
    DiffPIR path runs under ``torch.no_grad`` and never enters one."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def current_stream_handle(device: torch.device) -> int:
    if torch.cuda.current_device() != device.index:
        raise ValueError(f"tensor on {device} but the current CUDA device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {rc}")
