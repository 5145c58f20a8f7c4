"""RowGatherer (local) — x = b[rows] as a LinOp
(``ginkgo_tpu/matrix/row_gatherer.py`` in torch).

Analog of ``include/ginkgo/core/matrix/row_gatherer.hpp:43``.
"""

from __future__ import annotations

import torch

from ..base.linop import LinOp
from ..device import resolve_device
from .permutation import _on_device


class RowGatherer(LinOp):
    def __init__(self, rows, num_cols=0):
        self.rows = rows                # (num_out,) source row per output row
        self.num_cols = int(num_cols)   # domain size

    @property
    def shape(self):
        return (self.rows.shape[0], self.num_cols)

    def _apply(self, b):
        return b[self.rows.long()]

    def _apply_advanced(self, alpha, b, beta, x):
        return alpha * b[self.rows.long()] + beta * x

    @classmethod
    def from_indices(cls, rows, num_cols: int, index_dtype=torch.int32,
                     device=None):
        return cls(_on_device(rows, resolve_device(device), index_dtype),
                   num_cols=int(num_cols))
