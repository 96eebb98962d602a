"""The collectives of the sharded UNet and trajectory, written out.

In the JAX package GSPMD inserts every collective of a sharded program
(``diffpir_tpu/parallel/mesh.py:shard_image``, ``parallel/tp.py``).  PyTorch
has no such partitioner, so the port calls them itself, each over one axis
of a ``parallel.mesh.Mesh``:

  * ``all_reduce_sum``: the sum of the row-parallel products of tensor
    parallelism (``conv2``, ``emb_proj``, attention ``proj``); the bias is
    added once, after it, by the caller;
  * ``all_gather``: rank-ordered concatenation, over ``data`` (restored
    batches, per-sample losses) and over ``space`` (the UNet's output rows,
    attention tokens, GroupNorm partial statistics);
  * ``halo_rows``: the rows a convolution reads across a shard boundary of
    the image height, zeros only at the global top and bottom edges.

Only ``all_reduce`` and ``all_gather`` are called on a process group, the
two that both backends take.  On a gloo group a CUDA tensor is staged
through host memory, as gloo's own transport would; NCCL moves it on the
card.  The computation stays on the rank's device either way.  Adding zeros
is exact, so nothing here changes a value; only the order of a sum does.

Under an abstract mesh, or for a tensor on the ``meta`` device, nothing is
sent: the result has the right shape on ``meta`` and the collective is
recorded in ``mesh.log`` (when it is a list) as (op, axis, bytes moved per
rank), which is what ``Runner.lower_restore`` reports.

Gradients.  Each collective is differentiable, with the convention that a
tensor every rank of an axis holds whole (replicated) carries the whole
gradient on every rank, and a rank's block carries its block's gradient;
so a loss that every rank computes alike from replicated tensors (DPS_y0's
residual norm of the gathered image) gives every rank the unsharded
gradient.  Hence, Megatron's conjugate pairs:

  * ``all_reduce_sum`` (partial sums -> replicated): backward the identity;
  * ``grad_all_reduce`` (a replicated tensor entering a layer that splits
    its output, as a column-parallel conv or the sharded GroupNorm's
    merged statistics): the identity forward, the sum over the axis
    backward;
  * ``all_gather`` (blocks -> replicated): backward this rank's block;
  * ``axis_block`` (replicated -> block): backward the gather of the
    ranks' block gradients;
  * ``halo_rows``: backward each halo's gradient sent back to the rank it
    came from, added to its edge rows.

While a program is recorded (a ``torch.export`` trace, or
``kernels._common.operators()`` around a ``make_fx`` record of a gradient)
each emits its operator ``torch.ops.diffpir_tpu_torch.all_reduce_sum`` /
``grad_all_reduce`` / ``all_gather`` / ``axis_block`` / ``halo_rows``, which
take the axis's name and size, so the program's shapes are static and it
holds no rank's index: at run time each looks the axis up in
``parallel.mesh.current_mesh()`` and runs there.  Each operator's autograd
formula calls the operator of its backward above (``halo_rows_backward``
for the halo).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from diffpir_tpu_torch.kernels._common import define_op, emit_operators, wants_grad
from diffpir_tpu_torch.parallel.mesh import Mesh, current_mesh

__all__ = ["all_reduce_sum", "all_gather", "axis_block", "halo_rows", "grad_all_reduce",
           "host_staged"]

_OPS = torch.ops.diffpir_tpu_torch


def host_staged(mesh: Mesh, t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` goes through host memory: gloo with a
    tensor on the card."""
    return mesh.backend == "gloo" and t.device.type == "cuda"


def _record(mesh: Mesh, op: str, axis: str, nbytes: int) -> None:
    if mesh.log is not None:
        mesh.log.append((op, axis, int(nbytes)))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _size(mesh: Optional[Mesh], axis: str) -> int:
    return 1 if mesh is None else mesh.axis_size(axis)


# --- the collectives themselves, without gradients ---------------------------

def _all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    _record(mesh, "all_reduce", axis, _nbytes(t))
    if mesh.abstract or t.device.type == "meta":
        return torch.empty_like(t)
    group = mesh.groups[axis]
    if host_staged(mesh, t):
        buf = t.detach().to("cpu", copy=True)
        dist.all_reduce(buf, group=group)
        return buf.to(t.device)
    buf = t.detach().clone()
    dist.all_reduce(buf, group=group)
    return buf


def _all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axis)
    _record(mesh, "all_gather", axis, _nbytes(t) * (n - 1))
    if mesh.abstract or t.device.type == "meta":
        shape = list(t.shape)
        shape[dim] *= n
        return torch.empty(shape, dtype=t.dtype, device=t.device)
    group = mesh.groups[axis]
    src = t.detach().contiguous()
    if host_staged(mesh, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def _block(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    k = t.shape[dim] // mesh.axis_size(axis)
    return t.narrow(dim, mesh.axis_index(axis) * k, k)


def _halo(x: torch.Tensor, mesh: Mesh, axis: str, top: int, bottom: int) -> torch.Tensor:
    n, h = mesh.axis_size(axis), x.shape[1]
    if top > h or bottom > h:
        raise ValueError(f"a halo of {max(top, bottom)} rows needs shards of at least "
                         f"that many rows, have {h}")
    k = max(top, bottom)
    # each rank offers its first k and last k rows; rank r takes the last
    # `top` rows of rank r-1 and the first `bottom` rows of rank r+1
    edges = torch.stack([x[:, :k], x[:, h - k:]])          # (2, B, k, W, C)
    every = _all_gather(edges[None], mesh, axis, 0)        # (n, 2, B, k, W, C)
    r = mesh.axis_index(axis)
    parts = []
    if top:
        above = every[r - 1, 1, :, k - top:] if r > 0 else torch.zeros_like(x[:, :top])
        parts.append(above)
    parts.append(x)
    if bottom:
        below = every[r + 1, 0, :, :bottom] if r < n - 1 else torch.zeros_like(x[:, :bottom])
        parts.append(below)
    return torch.cat(parts, dim=1)


def _halo_backward(grad: torch.Tensor, mesh: Mesh, axis: str, top: int,
                   bottom: int) -> torch.Tensor:
    """The gradient of ``_halo`` for x: this rank's own rows' gradient, plus
    the gradients of the halo rows the neighbours took from it (rank r-1's
    bottom halo is rank r's first rows, rank r+1's top halo its last)."""
    n = mesh.axis_size(axis)
    h = grad.shape[1] - top - bottom
    k = max(top, bottom)
    g = grad[:, top:top + h].clone()
    shape = (grad.shape[0], k) + tuple(grad.shape[2:])
    g_top, g_bottom = grad.new_zeros(shape), grad.new_zeros(shape)
    if top:
        g_top[:, k - top:] = grad[:, :top]
    if bottom:
        g_bottom[:, :bottom] = grad[:, top + h:]
    every = _all_gather(torch.stack([g_top, g_bottom])[None], mesh, axis, 0)
    r = mesh.axis_index(axis)
    if top and r < n - 1:
        # rank r+1's top halo was this rank's last `top` rows
        g[:, h - top:] += every[r + 1, 0, :, k - top:]
    if bottom and r > 0:
        # rank r-1's bottom halo was this rank's first `bottom` rows
        g[:, :bottom] += every[r - 1, 1, :, :bottom]
    return g


# --- autograd --------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return _all_reduce(t, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GradAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous(), ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


class _AxisBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block(t, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, top, bottom):
        ctx.args = (mesh, axis, top, bottom)
        return _halo(x, mesh, axis, top, bottom)

    @staticmethod
    def backward(ctx, grad):
        return (_halo_backward(grad.contiguous(), *ctx.args),) + (None,) * 4


# --- the entry points --------------------------------------------------------

def all_reduce_sum(t: torch.Tensor, mesh: Optional[Mesh], axis: str) -> torch.Tensor:
    """The elementwise sum of ``t`` over the ranks along ``axis``."""
    n = _size(mesh, axis)
    if n == 1:
        return t
    if emit_operators():
        return _OPS.all_reduce_sum(t, axis, n)
    if wants_grad(t):
        return _AllReduceSum.apply(t, mesh, axis)
    return _all_reduce(t, mesh, axis)


def grad_all_reduce(t: torch.Tensor, mesh: Optional[Mesh], axis: str) -> torch.Tensor:
    """``t`` itself; its gradient is summed over the ranks along ``axis``
    (Megatron's conjugate of ``all_reduce_sum``).  Without a gradient to
    carry it is not even an operator."""
    n = _size(mesh, axis)
    if n == 1 or not wants_grad(t):
        return t
    if emit_operators():
        return _OPS.grad_all_reduce(t, axis, n)
    return _GradAllReduce.apply(t, mesh, axis)


def all_gather(t: torch.Tensor, mesh: Optional[Mesh], axis: str,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` concatenated on ``dim`` in rank order
    (each rank's ``t`` has the same shape)."""
    n = _size(mesh, axis)
    if n == 1:
        return t
    if emit_operators():
        return _OPS.all_gather(t, axis, n, dim)
    if wants_grad(t):
        return _AllGather.apply(t, mesh, axis, dim)
    return _all_gather(t, mesh, axis, dim)


def axis_block(t: torch.Tensor, mesh: Optional[Mesh], axis: str,
               dim: int = -1) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim``: the r-th of the axis's n
    equal blocks (a view where no gradient is asked for)."""
    n = _size(mesh, axis)
    if n == 1:
        return t
    if emit_operators():
        return _OPS.axis_block(t, axis, n, dim)
    if wants_grad(t):
        return _AxisBlock.apply(t, mesh, axis, dim)
    return _block(t, mesh, axis, dim)


def halo_rows(x: torch.Tensor, mesh: Optional[Mesh], axis: str, top: int,
              bottom: int) -> torch.Tensor:
    """NHWC ``x`` (this rank's rows of the image height over ``axis``) with
    ``top`` rows of the shard above prepended and ``bottom`` rows of the
    shard below appended: what a convolution reads across the boundary.  At
    the image's global top and bottom the added rows are zeros, the
    convolution's own padding."""
    n = _size(mesh, axis)
    if n == 1 or (top == 0 and bottom == 0):
        return x
    if emit_operators():
        return _OPS.halo_rows(x, axis, n, top, bottom)
    if wants_grad(x):
        return _HaloRows.apply(x, mesh, axis, top, bottom)
    return _halo(x, mesh, axis, top, bottom)


# --- the operators -------------------------------------------------------------

def _mesh_for(axis: str, n: int) -> Mesh:
    mesh = current_mesh()
    if mesh.axis_size(axis) != n:
        raise RuntimeError(f"the program was exported for a {axis!r} axis of {n} ranks; "
                           f"this process's mesh has {mesh.axis_size(axis)}")
    return mesh


def _gathered_fake(t, axis, n, dim):
    shape = list(t.shape)
    shape[dim] *= n
    return t.new_empty(shape)


def _block_fake(t, axis, n, dim):
    shape = list(t.shape)
    shape[dim] //= n
    return t.new_empty(shape)


def _halo_fake(x, axis, n, top, bottom):
    shape = list(x.shape)
    shape[1] += top + bottom
    return x.new_empty(shape)


def _halo_backward_fake(grad, axis, n, top, bottom):
    shape = list(grad.shape)
    shape[1] -= top + bottom
    return grad.new_empty(shape)


_OPERATORS = (
    # schema, implementation, fake, autograd formula (ctx.inputs: the args)
    ("all_reduce_sum(Tensor t, str axis, int n) -> Tensor",
     lambda t, axis, n: _all_reduce(t, _mesh_for(axis, n), axis),
     lambda t, axis, n: torch.empty_like(t),
     lambda ctx, g: (g, None, None)),
    ("grad_all_reduce(Tensor t, str axis, int n) -> Tensor",
     lambda t, axis, n: t.clone(),
     lambda t, axis, n: torch.empty_like(t),
     lambda ctx, g: (_OPS.all_reduce_sum(g, *ctx.inputs[1:]), None, None)),
    ("all_gather(Tensor t, str axis, int n, int dim) -> Tensor",
     lambda t, axis, n, dim: _all_gather(t, _mesh_for(axis, n), axis, dim),
     _gathered_fake,
     lambda ctx, g: (_OPS.axis_block(g, *ctx.inputs[1:]), None, None, None)),
    ("axis_block(Tensor t, str axis, int n, int dim) -> Tensor",
     lambda t, axis, n, dim: _block(t, _mesh_for(axis, n), axis, dim).clone(),
     _block_fake,
     lambda ctx, g: (_OPS.all_gather(g, *ctx.inputs[1:]), None, None, None)),
    ("halo_rows(Tensor x, str axis, int n, int top, int bottom) -> Tensor",
     lambda x, axis, n, top, bottom: _halo(x, _mesh_for(axis, n), axis, top, bottom),
     _halo_fake,
     lambda ctx, g: (_OPS.halo_rows_backward(g, *ctx.inputs[1:]),) + (None,) * 4),
    ("halo_rows_backward(Tensor grad, str axis, int n, int top, int bottom) -> Tensor",
     lambda g, axis, n, top, bottom: _halo_backward(g, _mesh_for(axis, n), axis, top,
                                                     bottom),
     _halo_backward_fake, None),
)
for _schema, _fn, _fake, _formula in _OPERATORS:
    define_op(_schema, {"CPU": _fn, "CUDA": _fn}, _fake, _formula)
