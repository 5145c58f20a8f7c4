"""Rank-overlapping distributed assembly
(``ginkgo_tpu/distributed/assembly.py`` in torch).

Analog of ``include/ginkgo/core/distributed/assembly.hpp`` /
``core/distributed/assembly.cpp`` (``assembly_mode::communicate``): each
rank contributes COO entries that may target rows owned by *other* ranks
(overlapping finite-element assembly); contributions to the same entry sum.

Assembly is build-time host work here, so "communication" is a concatenate
+ canonicalize; the result feeds ``read_distributed`` unchanged.
"""

from __future__ import annotations

import numpy as np

from ..base.matrix_data import MatrixData
from .matrix import DistributedMatrix
from .partition import Partition


def assemble_distributed(contributions, partition: Partition, mesh=None,
                         mode: str = "communicate", **kw):
    """contributions: list of MatrixData (one per contributing rank, global
    indices).  mode='communicate' sums cross-rank contributions;
    mode='local_only' drops entries whose row the contributor does not own
    (Ginkgo's default non-communicating read)."""
    if not contributions:
        raise ValueError("no contributions")
    shape = contributions[0].shape
    rows, cols, vals = [], [], []
    for rank, d in enumerate(contributions):
        if d.shape != shape:
            raise ValueError("contributions disagree on global shape")
        r, c, v = d.row_idx, d.col_idx, d.values
        if mode == "local_only":
            keep = partition.owner_of(r) == rank
            r, c, v = r[keep], c[keep], v[keep]
        elif mode != "communicate":
            raise ValueError(f"unknown assembly mode {mode!r}")
        rows.append(r)
        cols.append(c)
        vals.append(v)
    data = MatrixData(shape, np.concatenate(rows), np.concatenate(cols),
                      np.concatenate(vals)).canonical()
    return DistributedMatrix.from_data(data, partition, mesh, **kw)
