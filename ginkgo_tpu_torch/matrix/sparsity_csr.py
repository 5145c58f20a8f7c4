"""SparsityCsr — pattern-only matrix (``ginkgo_tpu/matrix/sparsity_csr.py``
in torch).

Analog of ``include/ginkgo/core/matrix/sparsity_csr.hpp:51``: stores only the
sparsity pattern plus one shared scalar value (default 1); used for symbolic
work (power patterns for ISAI, graph algorithms) and cheap pattern SpMV.
It has no plan: its apply is ``coo_spmv`` with the value times ones.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.linop import LinOp
from ..base.matrix_data import MatrixData
from ..device import resolve_device
from ..ops.registry import lookup


class SparsityCsr(LinOp):
    def __init__(self, row_idx, col_idx, value, shape, nnz):
        self.row_idx = row_idx      # (nnz_stored,) padded with n
        self.col_idx = col_idx      # (nnz_stored,) padded with 0
        self.value = value          # () shared scalar tensor
        self.shape = tuple(shape)
        self.nnz = int(nnz)

    def _apply(self, b):
        ones = (self.row_idx < self.shape[0]).to(b.dtype)
        y = lookup("coo_spmv", b.device)(self.row_idx, self.col_idx, ones, b,
                                         self.shape[0])
        return self.value.to(b.dtype) * y

    @classmethod
    def from_data(cls, data: MatrixData, value=1.0, index_dtype=torch.int32,
                  pad_multiple: int = 8, device=None):
        from .coo import pad_nnz
        from .csr import _upload
        device = resolve_device(device)
        d = data.canonical()
        nnz = d.nnz
        cap = pad_nnz(nnz, pad_multiple)
        rows = np.full(cap, d.shape[0], np.int64)
        cols = np.zeros(cap, np.int64)
        rows[:nnz] = d.row_idx
        cols[:nnz] = d.col_idx
        return cls(row_idx=_upload(rows, device, index_dtype),
                   col_idx=_upload(cols, device, index_dtype),
                   value=torch.as_tensor(np.asarray(value)).to(device), shape=d.shape,
                   nnz=nnz)

    @classmethod
    def from_pattern_of(cls, op, value=1.0, device=None):
        if device is None and isinstance(op, LinOp):
            device = op.device
        return cls.from_data(op.to_matrix_data(), value=value, device=device)

    def to_dense(self):
        n, m = self.shape
        vals = torch.full(self.row_idx.shape, 1, dtype=self.value.dtype,
                          device=self.value.device) * self.value
        out = torch.zeros((n + 1, m), dtype=vals.dtype, device=vals.device)
        out.index_put_((self.row_idx.long(), self.col_idx.long()), vals,
                       accumulate=True)
        return out[:n]

    def to_matrix_data(self) -> MatrixData:
        nnz = self.nnz
        v = float(self.value)
        return MatrixData(self.shape, self.row_idx[:nnz].cpu().numpy(),
                          self.col_idx[:nnz].cpu().numpy(),
                          np.full(nnz, v))

    def to_adjacency(self):
        """(rows, cols) numpy pattern for host graph algorithms."""
        return (self.row_idx[:self.nnz].cpu().numpy(),
                self.col_idx[:self.nnz].cpu().numpy())
