"""Argument checks shared by the kernel wrappers, and the port's operators."""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)

# the namespace of the port's operators, torch.ops.diffpir_tpu_torch.*
OPS_NAMESPACE = "diffpir_tpu_torch"
_LIB = torch.library.Library(OPS_NAMESPACE, "FRAGMENT")
# (operator name, dispatch key) -> the implementation define_op registered
OP_IMPLS: dict[tuple[str, str], Callable] = {}
# set while export.py records a program (``operators()``)
_RECORDING = False


@contextlib.contextmanager
def operators():
    """While open, the kernel wrappers and the collectives emit their
    operators (``torch.ops.diffpir_tpu_torch.*``) instead of running, as
    they do inside a ``torch.export`` trace: ``export.py`` opens it around
    the ``make_fx`` records of a gradient (the first-order prox, DPS)."""
    global _RECORDING
    before, _RECORDING = _RECORDING, True
    try:
        yield
    finally:
        _RECORDING = before


def emit_operators() -> bool:
    """Whether a wrapper must emit its operator: inside a ``torch.export``
    trace or an ``operators()`` record."""
    return _RECORDING or torch.compiler.is_exporting()


def define_op(schema: str, impls: dict[str, Callable], fake: Callable,
              backward: Optional[Callable] = None, saved: Sequence[int] = ()) -> None:
    """Define the operator ``torch.ops.diffpir_tpu_torch.<name>`` from its
    schema, one implementation per dispatch key (``"CPU"``, ``"CUDA"``) and
    a fake implementation that gives the output's shape and type (what a
    ``torch.export`` trace runs).  Registered directly with the dispatcher:
    ``torch.library.custom_op`` wraps each call in Python layers (autograd,
    aliasing checks) that on the card's host cost about as much again as the
    kernel's own wrapper (PERF.md §6); the loader calls the
    implementations without the dispatcher (``export._bind_kernels``).

    ``backward(ctx, grad)``, where given, is the operator's autograd formula
    (``torch.library.register_autograd``): ``ctx.inputs`` holds the call's
    arguments, those at the indices ``saved`` saved as tensors, and
    ``ctx.needs_input_grad`` which of them want a gradient.  The formulas
    call operators of their own, so a ``make_fx`` record of a gradient holds
    one backward node per forward node."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    for key, fn in impls.items():
        _LIB.impl(name, fn, key)
        OP_IMPLS[(name, key)] = fn
    torch.library.register_fake(f"{OPS_NAMESPACE}::{name}", fake, lib=_LIB)
    if backward is None:
        return

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*(inputs[i] for i in saved))
        ctx.args = tuple(None if i in saved or torch.is_tensor(a) else a
                         for i, a in enumerate(inputs))
        ctx.saved = tuple(saved)

    def formula(ctx, grad):
        args = list(ctx.args)
        for i, t in zip(ctx.saved, ctx.saved_tensors):
            args[i] = t
        ctx.inputs = args
        return backward(ctx, grad)

    torch.library.register_autograd(f"{OPS_NAMESPACE}::{name}", formula,
                                    setup_context=setup_context, lib=_LIB)


@contextlib.contextmanager
def autograd_below_dispatch():
    """Let autograd record inside an operator's implementation.  The
    dispatcher runs an implementation with the autograd keys excluded (and,
    inside a ``make_fx`` record, grad mode off); a backward operator that
    recomputes a plain version and differentiates it needs them back."""
    exc = torch._C._dispatch_tls_local_exclude_set()
    for key in (torch._C.DispatchKey.ADInplaceOrView,
                torch._C.DispatchKey.AutogradFunctionality,
                torch._C.DispatchKey.AutogradOther):
        exc = exc.remove(key)
    with torch._C._ForceDispatchKeyGuard(torch._C._dispatch_tls_local_include_set(),
                                         exc), torch.enable_grad():
        yield


def recompute_grads(plain: Callable, grad: torch.Tensor, tensors: Sequence,
                    needs: Sequence[bool], *static) -> list:
    """The gradients of ``plain(*tensors, *static)`` against ``grad`` for
    the tensors whose ``needs`` is set, by recomputing ``plain`` and
    differentiating it (what each kernel's backward does: the kernels are
    forward-only); an empty tensor for every other slot."""
    ins = [None if t is None else t.detach().requires_grad_(bool(n))
           for t, n in zip(tensors, needs)]
    wanted = [t for t in ins if t is not None and t.requires_grad]
    out = []
    if wanted:
        with autograd_below_dispatch():
            y = plain(*ins, *static)
            got = iter(torch.autograd.grad(y, wanted, grad))
    for t in ins:
        out.append(next(got) if t is not None and t.requires_grad
                   else grad.new_empty(0))
    return out


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
