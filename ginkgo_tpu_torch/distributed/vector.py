"""Distributed Vector (``ginkgo_tpu/distributed/vector.py`` in torch).

Analog of ``include/ginkgo/core/distributed/vector.hpp`` /
``core/distributed/vector.cpp:473-491``: a row-partitioned multivector whose
BLAS-1 reductions are global.  On a one-device mesh the underlying tensor
is the global padded array and a reduction over it is the global one.  On
a mesh over ranks it is a ``DTensor`` of the same global padded layout,
sharded over its rows (``Shard(0)``: each rank holds its parts' rows), and
a reduction is a local sum plus an all-reduce, as the reference's
``psum`` (``matrix.dense`` hands every rank the all-reduced values).

The class is a *view* carrying the Partition (for natural<->padded layout
conversion) rather than a communication engine.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..log.profiler_hook import span
from ..matrix.dense import (compute_conj_dot, compute_dot, compute_norm1,
                            compute_norm2)
from .partition import Partition


def local_rows(t):
    """This rank's rows of a sharded vector; a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def global_tensor(t):
    """The whole padded tensor on every rank (an all-gather of a sharded
    vector); a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def placements(mesh, axis: str):
    """The DTensor placements of a vector partitioned over ``mesh[axis]``
    (its rows sharded there, replicated over any other mesh axis)."""
    return [Shard(0) if name == axis else Replicate()
            for name in mesh.axis_names]


def shard(local, mesh, axis: str = "rows", like=None):
    """This rank's rows ``local`` as the vector partitioned over
    ``mesh[axis]`` (a DTensor); on a one-device mesh ``local`` itself.
    ``like``: a DTensor whose mesh and placements the result takes."""
    if like is not None:
        mesh_, place = like.device_mesh, like.placements
    elif mesh.ranked:
        mesh_, place = mesh.device_mesh, placements(mesh, axis)
    else:
        return local
    shards = math.prod(mesh_.size(dim) for dim, p in enumerate(place)
                       if p == Shard(0))
    shape = (local.shape[0] * shards,) + tuple(local.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh_, place, run_check=False,
                              shape=shape, stride=stride)


def row_parts(mesh, axis: str = "rows") -> range:
    """The parts of ``mesh[axis]`` whose rows this process holds of a
    vector partitioned over that axis (all of them on a one-device
    mesh)."""
    if not mesh.ranked:
        return range(mesh.shape[axis])
    coords = np.argwhere(mesh.ranks == mesh.rank)[
        :, mesh.axis_names.index(axis)]
    return range(int(coords.min()), int(coords.max()) + 1)


def on_rows(t, mesh, axis: str = "rows"):
    """``t`` as a vector sharded over ``mesh[axis]``: a DTensor of
    another layout is redistributed; a plain tensor must be this rank's
    rows already."""
    if not mesh.ranked:
        return t
    want = placements(mesh, axis)
    if isinstance(t, DTensor):
        if list(t.placements) != want:
            t = t.redistribute(mesh.device_mesh, want)
        return t
    raise TypeError("an operator over ranks takes vectors sharded over "
                    "them (distribute_vector), got a plain tensor of shape "
                    f"{tuple(t.shape)}")


def _to_padded(x, partition: Partition):
    """The natural (n, k) block ``x`` in the padded layout, on its
    device (``x`` itself where every part is full)."""
    if partition.padded_size == partition.global_size:
        return x
    local, r = partition.local_size, partition.ranges
    out = x.new_zeros((partition.padded_size,) + tuple(x.shape[1:]))
    for p in range(partition.num_parts):
        out[p * local:p * local + r[p + 1] - r[p]] = x[r[p]:r[p + 1]]
    return out


def _from_padded(xp, partition: Partition):
    """The padded block ``xp`` in the natural layout, on its device."""
    if partition.padded_size == partition.global_size:
        return xp
    local, r = partition.local_size, partition.ranges
    return torch.cat([xp[p * local:p * local + r[p + 1] - r[p]]
                      for p in range(partition.num_parts)])


def scatter_rows(x, partition: Partition, mesh, *, cols=None, dtype=None):
    """The natural (n, k) block ``x`` on rank 0's device as the vector of
    the padded layout sharded over the mesh's rows (``Shard(0)``; each
    rank's rows): one scatter of equal pieces, device to device.  The
    other ranks pass ``x`` None and the block's ``cols`` and ``dtype``.
    On a one-device mesh, the padded block itself."""
    with span("dist.scatter"):
        if not mesh.ranked:
            return _to_padded(x, partition)
        rows = len(row_parts(mesh)) * partition.local_size
        pieces = None
        if mesh.rank == 0:
            cols, dtype = x.shape[1], x.dtype
            pieces = list(_to_padded(x, partition).contiguous().split(rows))
        out = torch.empty((rows, cols), dtype=dtype, device=mesh.device)
        dist.scatter(out, pieces, src=0)
        return shard(out, mesh)


def gather_rows(v, partition: Partition, mesh):
    """The natural (n, k) block of the sharded vector ``v`` on rank 0's
    device, None on the other ranks: one gather of equal pieces, device to
    device.  On a one-device mesh, ``v`` in the natural layout."""
    with span("dist.gather"):
        if not mesh.ranked:
            return _from_padded(v, partition)
        mine = local_rows(v).contiguous()
        full = pieces = None
        if mesh.rank == 0:
            full = mine.new_empty((partition.padded_size,)
                                  + tuple(mine.shape[1:]))
            pieces = list(full.split(mine.shape[0]))
        dist.gather(mine, pieces, dst=0)
        return None if full is None else _from_padded(full, partition)


class Vector:
    """Row-distributed multivector: padded tensor + partition."""

    def __init__(self, array, partition=None):
        self.array = array            # (padded_size,) or (padded, k)
        self.partition = partition

    @classmethod
    def from_global(cls, x, partition: Partition, mesh, axis="rows"):
        from .matrix import distribute_vector
        return cls(array=distribute_vector(x, partition, mesh, axis),
                   partition=partition)

    def to_global(self) -> np.ndarray:
        """The natural-order vector on the host (gathered from every
        rank)."""
        return self.partition.from_padded(
            global_tensor(self.array).cpu().numpy())

    @property
    def shape(self):
        return tuple(self.array.shape)

    def _2d(self):
        return self.array[:, None] if self.array.ndim == 1 else self.array

    # -- global BLAS-1 --------------------------------------------------------
    def compute_dot(self, other):
        return compute_dot(self._2d(), other._2d())

    def compute_conj_dot(self, other):
        return compute_conj_dot(self._2d(), other._2d())

    def compute_norm2(self):
        return compute_norm2(self._2d())

    def compute_norm1(self):
        return compute_norm1(self._2d())

    def scale(self, alpha):
        return Vector(array=self.array * alpha, partition=self.partition)

    def add_scaled(self, alpha, other):
        return Vector(array=self.array + alpha * other.array,
                      partition=self.partition)

    def create_subvector(self, cols):
        """Column-subset view (the reference v1.11's non-owning distributed
        sub-vector): every row kept, the selected columns."""
        return Vector(array=self._2d()[:, cols], partition=self.partition)

    def local_view(self, rank: int):
        """Part ``rank``'s rows (host-side convenience)."""
        local = self.partition.local_size
        real = int(self.partition.part_sizes()[rank])
        full = global_tensor(self.array)
        return full[rank * local:rank * local + real].cpu().numpy()
