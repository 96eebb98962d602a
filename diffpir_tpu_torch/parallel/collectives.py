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

Inside a ``torch.export`` trace, ``all_reduce_sum``, ``all_gather`` and
``axis_block`` (this rank's block of a tensor) emit the operators
``torch.ops.diffpir_tpu_torch.all_reduce_sum`` / ``all_gather`` /
``axis_block``, which take the axis's name and size, so the program's shapes
are static and it holds no rank's index: at run time each looks the axis up
in ``parallel.mesh.current_mesh()`` and runs the function above on it.
``halo_rows`` has no operator (bundles over a ``space`` axis are refused).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from diffpir_tpu_torch.kernels._common import define_op
from diffpir_tpu_torch.parallel.mesh import Mesh, current_mesh

__all__ = ["all_reduce_sum", "all_gather", "axis_block", "halo_rows", "host_staged"]


def host_staged(mesh: Mesh, t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` goes through host memory: gloo with a
    tensor on the card."""
    return mesh.backend == "gloo" and t.device.type == "cuda"


def _record(mesh: Mesh, op: str, axis: str, nbytes: int) -> None:
    if mesh.log is not None:
        mesh.log.append((op, axis, int(nbytes)))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce_sum(t: torch.Tensor, mesh: Optional[Mesh], axis: str) -> torch.Tensor:
    """The elementwise sum of ``t`` over the ranks along ``axis``."""
    n = 1 if mesh is None else mesh.axis_size(axis)
    if n == 1:
        return t
    if torch.compiler.is_exporting():
        return torch.ops.diffpir_tpu_torch.all_reduce_sum(t, axis, n)
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


def all_gather(t: torch.Tensor, mesh: Optional[Mesh], axis: str,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` concatenated on ``dim`` in rank order
    (each rank's ``t`` has the same shape)."""
    n = 1 if mesh is None else mesh.axis_size(axis)
    if n == 1:
        return t
    if torch.compiler.is_exporting():
        return torch.ops.diffpir_tpu_torch.all_gather(t, axis, n, dim)
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


def axis_block(t: torch.Tensor, mesh: Optional[Mesh], axis: str,
               dim: int = -1) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim``: the r-th of the axis's n
    equal blocks (a view)."""
    n = 1 if mesh is None else mesh.axis_size(axis)
    if n == 1:
        return t
    if torch.compiler.is_exporting():
        return torch.ops.diffpir_tpu_torch.axis_block(t, axis, n, dim)
    k = t.shape[dim] // n
    return t.narrow(dim, mesh.axis_index(axis) * k, k)


def _mesh_for(axis: str, n: int) -> Mesh:
    mesh = current_mesh()
    if mesh.axis_size(axis) != n:
        raise RuntimeError(f"the program was exported for a {axis!r} axis of {n} ranks; "
                           f"this process's mesh has {mesh.axis_size(axis)}")
    return mesh


def _all_reduce_sum_op(t, axis, n):
    return all_reduce_sum(t, _mesh_for(axis, n), axis)


def _all_gather_op(t, axis, n, dim):
    return all_gather(t, _mesh_for(axis, n), axis, dim)


def _all_gather_fake(t, axis, n, dim):
    shape = list(t.shape)
    shape[dim] *= n
    return t.new_empty(shape)


def _axis_block_op(t, axis, n, dim):
    return axis_block(t, _mesh_for(axis, n), axis, dim).clone()


def _axis_block_fake(t, axis, n, dim):
    shape = list(t.shape)
    shape[dim] //= n
    return t.new_empty(shape)


for _schema, _fn, _fake in (
        ("all_reduce_sum(Tensor t, str axis, int n) -> Tensor", _all_reduce_sum_op,
         lambda t, axis, n: torch.empty_like(t)),
        ("all_gather(Tensor t, str axis, int n, int dim) -> Tensor", _all_gather_op,
         _all_gather_fake),
        ("axis_block(Tensor t, str axis, int n, int dim) -> Tensor", _axis_block_op,
         _axis_block_fake)):
    define_op(_schema, {"CPU": _fn, "CUDA": _fn}, _fake)


def halo_rows(x: torch.Tensor, mesh: Optional[Mesh], axis: str, top: int,
              bottom: int) -> torch.Tensor:
    """NHWC ``x`` (this rank's rows of the image height over ``axis``) with
    ``top`` rows of the shard above prepended and ``bottom`` rows of the
    shard below appended: what a convolution reads across the boundary.  At
    the image's global top and bottom the added rows are zeros, the
    convolution's own padding."""
    n = 1 if mesh is None else mesh.axis_size(axis)
    if n == 1 or (top == 0 and bottom == 0):
        return x
    h = x.shape[1]
    if top > h or bottom > h:
        raise ValueError(f"a halo of {max(top, bottom)} rows needs shards of at least "
                         f"that many rows, have {h}")
    k = max(top, bottom)
    # each rank offers its first k and last k rows; rank r takes the last
    # `top` rows of rank r-1 and the first `bottom` rows of rank r+1
    edges = torch.stack([x[:, :k], x[:, h - k:]])          # (2, B, k, W, C)
    every = all_gather(edges[None], mesh, axis, dim=0)     # (n, 2, B, k, W, C)
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
