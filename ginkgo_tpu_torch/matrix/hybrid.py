"""Hybrid (ELL + COO tail) format (``ginkgo_tpu/matrix/hybrid.py`` in
torch).

Analog of ``include/ginkgo/core/matrix/hybrid.hpp:42`` with its partition
strategies: the first ``ell_width`` entries of each row go to an ELL part,
the overflow to a COO tail.  Strategies pick ``ell_width`` from the
row-length distribution: ``imbalance_limit`` (percentile), ``automatic``
(Ginkgo's 80th percentile default), ``column_limit``,
``minimal_storage_limit``.  The SpMV plan covers the full pattern: the
packed layout's own ELL + tail split subsumes the partition.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.linop import LinOp
from ..base.matrix_data import MatrixData
from ..device import resolve_device
from .coo import Coo
from .ell import Ell, row_positions


def _pick_width(lengths: np.ndarray, strategy, percent: float,
                column_limit: int | None):
    if column_limit is not None:
        return int(column_limit)
    if lengths.size == 0:
        return 1
    if strategy == "column_limit":
        raise ValueError("column_limit strategy needs column_limit=")
    if strategy == "minimal_storage_limit":
        # ELL stores width per row; COO stores 2 indices + value per entry:
        # keep entries in ELL while the marginal column is >~2/3 full.
        widths = np.arange(0, lengths.max() + 1)
        ell_cost = widths * lengths.size * 2
        coo_cost = 3 * np.array([(np.maximum(lengths - w, 0)).sum()
                                 for w in widths])
        return int(widths[np.argmin(ell_cost + coo_cost)])
    # imbalance_limit / automatic: percentile of row lengths
    return int(np.percentile(lengths, percent * 100))


class Hybrid(LinOp):
    def __init__(self, ell, coo, shape, nnz, fast_op=None):
        self.ell = ell
        self.coo = coo
        self.shape = tuple(shape)
        self.nnz = int(nnz)
        self.fast_op = fast_op      # SpmvPlan fast path

    def _apply(self, b):
        if self.fast_op is not None:
            return self.fast_op._apply(b)
        return self.ell._apply(b) + self.coo._apply(b)

    @classmethod
    def from_data(cls, data: MatrixData, dtype=None, index_dtype=torch.int32,
                  strategy: str = "automatic", percent: float = 0.8,
                  column_limit: int | None = None, fast: bool = True,
                  device=None):
        device = resolve_device(device)
        d = data.canonical()
        n, m = d.shape
        row_ptr = d.row_ptrs()
        lengths = np.diff(row_ptr)
        w = max(1, _pick_width(lengths, strategy, percent, column_limit))
        in_ell = row_positions(row_ptr) < w
        ell_part = MatrixData((n, m), d.row_idx[in_ell], d.col_idx[in_ell],
                              d.values[in_ell])
        coo_part = MatrixData((n, m), d.row_idx[~in_ell], d.col_idx[~in_ell],
                              d.values[~in_ell])
        fast_op = None
        if fast and d.nnz:
            from .fastpath import plan_fast_spmv
            fast_op = plan_fast_spmv(d, dtype, index_dtype, device=device)
        return cls(ell=Ell.from_data(ell_part, dtype, index_dtype, width=w,
                                     fast=False, device=device),
                   coo=Coo.from_data(coo_part, dtype, index_dtype,
                                     fast=False, device=device),
                   shape=(n, m), nnz=d.nnz, fast_op=fast_op)

    def to_dense(self):
        return self.ell.to_dense() + self.coo.to_dense()

    def compute_absolute(self):
        """|A| entrywise (AbsoluteComputable; abs over the value tensors)."""
        from ..base.linop import absolute_of_storage
        return absolute_of_storage(self)

    def to_matrix_data(self) -> MatrixData:
        e = self.ell.to_matrix_data()
        c = self.coo.to_matrix_data()
        return MatrixData(self.shape,
                          np.concatenate([e.row_idx, c.row_idx]),
                          np.concatenate([e.col_idx, c.col_idx]),
                          np.concatenate([e.values, c.values])).canonical()

    def to_csr(self, **kwargs):
        from .csr import Csr
        kwargs.setdefault("device", self.ell.values.device)
        return Csr.from_data(self.to_matrix_data(), **kwargs)
