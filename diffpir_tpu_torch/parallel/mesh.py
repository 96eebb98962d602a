"""Device meshes over ``torch.distributed`` ranks, and batch sharding.

Port of ``diffpir_tpu/parallel/mesh.py``.  The JAX package puts every device
of one process on a ``jax.sharding.Mesh`` and lets GSPMD place arrays and
insert the collectives.  Here a rank is one device: a ``Mesh`` is a grid of
the ranks of the default process group with the axis names ``data``,
``model`` and ``space``, this rank's coordinate on each axis, and one process
group per axis (the ranks that differ from this one only on that axis).
``shard_batch``, ``shard_image`` and ``replicate`` return this rank's part of
a tensor: rows of B, rows of H, or all of it.  The collectives that GSPMD
would insert are written out in ``parallel/collectives.py``.

A mesh whose ranks share one card runs over gloo (NCCL refuses two ranks on
one device); a mesh with one card per rank runs over NCCL.  An abstract mesh
(``abstract_mesh``) has a shape and a coordinate but no process group: under
it the collectives only record what they would move, for ``Runner.lower_restore``
on the ``meta`` device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "abstract_mesh", "shard_batch", "shard_image",
           "shard_tensor", "replicate", "current_mesh", "set_current_mesh", "AXES"]

AXES = ("data", "model", "space")

# the mesh the collective operators of an exported program run over
# (parallel/collectives.py): the last one ``make_mesh`` made, or the one a
# loaded bundle set
_CURRENT: Optional["Mesh"] = None


def current_mesh() -> "Mesh":
    """The mesh whose process groups the collective operators use; raises
    when no mesh has been made in this process."""
    if _CURRENT is None:
        raise RuntimeError("no device mesh in this process: make one with make_mesh")
    return _CURRENT


def set_current_mesh(mesh: Optional["Mesh"]) -> None:
    global _CURRENT
    _CURRENT = mesh


class Mesh:
    """A grid of ranks with named axes.

    ``shape`` maps each axis name to its size, in the mesh's axis order (as
    ``jax.sharding.Mesh.shape``); ``coords`` maps it to this rank's index on
    that axis; ``groups`` to the process group along it (None for an axis of
    size 1 and on an abstract mesh).  ``host_group`` is a gloo group over
    every rank of the mesh, for coordinating host-side decisions.  ``log``,
    when a list, receives one record per collective (op, axis, bytes).
    """

    def __init__(self, shape: dict, coords: dict, groups: dict, *,
                 host_group=None, backend: str = "gloo", abstract: bool = False):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.coords = dict(coords)
        self.groups = dict(groups)
        self.host_group = host_group
        self.backend = backend
        self.abstract = abstract
        self.log: Optional[list] = None

    def axis_size(self, axis: Optional[str]) -> int:
        """Ranks along ``axis``; 1 for None or an axis the mesh lacks."""
        return self.shape.get(axis, 1) if axis else 1

    def axis_index(self, axis: Optional[str]) -> int:
        """This rank's index along ``axis``; 0 for None or an absent axis."""
        return self.coords.get(axis, 0) if axis else 0

    def __repr__(self) -> str:
        kind = "abstract " if self.abstract else ""
        return f"Mesh({kind}{self.shape}, coords={self.coords}, backend={self.backend})"


def _check(shape: Sequence[int], axis_names: Sequence[str]) -> tuple:
    axes = tuple(axis_names)
    if len(axes) != len(shape):
        raise ValueError(f"axis names {axes} do not match mesh shape {tuple(shape)}")
    bad = [a for a in axes if a not in AXES]
    if bad or len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes must be unique names from {AXES}, got {axes}")
    return axes


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """A mesh over the ranks of the default process group; by default 1-D
    data-parallel over all of them.  Raises, as the JAX package does, when
    the shape needs more ranks than exist, and also when it leaves ranks
    out (each rank runs the same program).  Every rank must call it, in the
    same order as its other process-group calls."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    axes = _check(shape, axis_names)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh shape {shape} uses {n} of the {world} ranks; start "
                         f"{n} ranks")
    grid = np.arange(n).reshape(shape)
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    groups: dict = {}
    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    for i, axis in enumerate(axes):
        groups[axis] = None
        if shape[i] == 1:
            continue
        # every line of the grid along this axis becomes a group; all ranks
        # make all of them, in one order
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    host = None
    if world > 1:
        host = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    mesh = Mesh(dict(zip(axes, shape)), coords, groups, host_group=host, backend=backend)
    set_current_mesh(mesh)
    return mesh


def abstract_mesh(shape: Sequence[int], axis_names: Sequence[str],
                  coords: Optional[dict] = None) -> Mesh:
    """A mesh of ``shape`` with no process group (rank 0's coordinate unless
    ``coords`` says otherwise): its collectives only record their bytes."""
    axes = _check(tuple(shape), axis_names)
    coords = {a: 0 for a in axes} if coords is None else dict(coords)
    return Mesh(dict(zip(axes, (int(s) for s in shape))), coords,
                {a: None for a in axes}, abstract=True)


def _rows(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} of {n} does not split over {parts} ranks")
    per = n // parts
    return slice(index * per, (index + 1) * per)


def shard_batch(arr, mesh: Mesh, axis: Optional[str] = "data"):
    """This rank's rows of the leading (batch) dim over ``axis``; ``axis=None``
    (or an axis the mesh lacks) replicates."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return arr
    return arr[_rows(arr.shape[0], mesh.axis_size(axis), mesh.axis_index(axis), "batch")]


def shard_image(arr, mesh: Mesh, data_axis: Optional[str] = "data",
                space_axis: Optional[str] = None):
    """This rank's part of an NHWC batch: rows of B over ``data_axis`` and
    rows of H over ``space_axis`` (spatial parallelism)."""
    arr = shard_batch(arr, mesh, data_axis)
    if mesh is None or mesh.axis_size(space_axis) == 1:
        return arr
    rows = _rows(arr.shape[1], mesh.axis_size(space_axis), mesh.axis_index(space_axis),
                 "image height")
    return arr[:, rows]


def shard_tensor(t, spec, mesh: Mesh):
    """This rank's block of ``t`` under ``spec``: per dim the mesh axis it is
    split over (None for none; ``()`` replicates), rank r of an axis of n
    taking the r-th of n equal blocks (``parallel/tp.py``'s specs)."""
    for dim, axis in enumerate(spec):
        n = mesh.axis_size(axis)
        if n > 1:
            t = t[(slice(None),) * dim + (_rows(t.shape[dim], n, mesh.axis_index(axis),
                                                f"dim {dim}"),)]
    return t


def replicate(tree, mesh: Mesh):
    """Every rank holds all of ``tree`` (the parameters of dp and sp): with
    one process per rank each already holds its own copy."""
    return tree

