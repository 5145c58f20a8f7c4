"""Distributed Vector (``ginkgo_tpu/distributed/vector.py`` in torch).

Analog of ``include/ginkgo/core/distributed/vector.hpp`` /
``core/distributed/vector.cpp:473-491``: a row-partitioned multivector whose
BLAS-1 reductions are global.  The parts of a mesh share one device, so the
underlying tensor is the global padded array and a reduction over it is the
global one; this class is a *view* carrying the Partition (for
natural<->padded layout conversion) rather than a communication engine.
"""

from __future__ import annotations

import numpy as np

from ..matrix.dense import (compute_conj_dot, compute_dot, compute_norm1,
                            compute_norm2)
from .partition import Partition


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
        return self.partition.from_padded(self.array.cpu().numpy())

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
        """This rank's rows (host-side convenience)."""
        local = self.partition.local_size
        real = int(self.partition.part_sizes()[rank])
        return self.array[rank * local:rank * local + real].cpu().numpy()
