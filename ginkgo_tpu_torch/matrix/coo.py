"""COO format (``include/ginkgo/core/matrix/coo.hpp:50``;
``ginkgo_tpu/matrix/coo.py`` in torch).

Arrays are padded to ``nnz_stored >= nnz`` with ``row = num_rows, col = 0,
val = 0``; ``coo_spmv`` drops the ``num_rows`` row, so padding is inert.
``from_data`` also plans the pattern into the banded or packed layout
(``matrix/fastpath.py``) when one is economical, and then applies through
kernel A or B.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.linop import LinOp
from ..base.matrix_data import MatrixData
from ..device import resolve_device
from ..ops.registry import lookup


def pad_nnz(nnz: int, multiple: int) -> int:
    return max(multiple, -(-nnz // multiple) * multiple)


class Coo(LinOp):
    def __init__(self, row_idx, col_idx, values, shape, nnz, fast_op=None):
        self.row_idx = row_idx      # (nnz_stored,) int
        self.col_idx = col_idx      # (nnz_stored,) int
        self.values = values        # (nnz_stored,)
        self.shape = tuple(shape)
        self.nnz = int(nnz)
        self.fast_op = fast_op      # SpmvPlan fast path (matrix/fastpath.py)

    def _apply(self, b):
        if self.fast_op is not None:
            return self.fast_op._apply(b)
        return lookup("coo_spmv", b.device)(self.row_idx, self.col_idx,
                                            self.values, b, self.shape[0])

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_data(cls, data: MatrixData, dtype=None, index_dtype=torch.int32,
                  pad_multiple: int = 8, fast: bool = True, device=None):
        """Pad ``data`` and, with ``fast``, plan its fast layout; the
        tensors go to ``device`` (``None``: the CUDA device)."""
        from .csr import _upload, host_value_types
        device = resolve_device(device)
        d = data.canonical()
        nnz = d.nnz
        vdtype, host = host_value_types(d.values.dtype, dtype)
        cap = pad_nnz(nnz, pad_multiple)
        rows = np.full(cap, d.shape[0], np.int64)
        cols = np.zeros(cap, np.int64)
        vals = np.zeros(cap, host)
        rows[:nnz] = d.row_idx
        cols[:nnz] = d.col_idx
        vals[:nnz] = d.values
        fast_op = None
        if fast and nnz:
            from .fastpath import plan_fast_spmv
            fast_op = plan_fast_spmv(d, dtype, index_dtype, device=device)
        return cls(row_idx=_upload(rows, device, index_dtype),
                   col_idx=_upload(cols, device, index_dtype),
                   values=_upload(vals, device, vdtype), shape=d.shape,
                   nnz=nnz, fast_op=fast_op)

    # -- conversions ------------------------------------------------------------
    def to_dense(self):
        n, m = self.shape
        out = torch.zeros((n + 1, m), dtype=self.values.dtype,
                          device=self.values.device)
        out.index_put_((self.row_idx.long(), self.col_idx.long()),
                       self.values, accumulate=True)
        return out[:n]

    def to_csr(self, strategy="classical"):
        """Device-side conversion (classical layout); the other strategies
        plan on the host through ``Csr.from_data``."""
        from .csr import Csr
        if strategy not in ("classical", "load_balance", "merge_path",
                            "sparselib"):
            return Csr.from_data(self.to_matrix_data(), strategy=strategy,
                                 dtype=self.values.dtype,
                                 index_dtype=self.row_idx.dtype,
                                 device=self.values.device)
        n = self.shape[0]
        rows = self.row_idx[:self.nnz].long()
        row_ptr = torch.zeros(n + 1, dtype=self.row_idx.dtype,
                              device=rows.device)
        row_ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), dim=0)
        return Csr(row_ptr=row_ptr, col_idx=self.col_idx, values=self.values,
                   row_idx=self.row_idx, shape=self.shape, nnz=self.nnz)

    def transpose(self):
        """Device-side transpose: stable re-sort by (col, row); padded
        entries keep sorting last so the result stays row-major-sorted."""
        pad = self.row_idx >= self.shape[0]
        primary = torch.where(pad, self.shape[1], self.col_idx)
        o1 = torch.argsort(self.row_idx, stable=True)
        order = o1[torch.argsort(primary[o1], stable=True)]
        pad_s = pad[order]
        new_rows = torch.where(pad_s, self.shape[1], self.col_idx[order])
        new_cols = torch.where(pad_s, 0, self.row_idx[order])
        return Coo(row_idx=new_rows, col_idx=new_cols,
                   values=torch.where(pad_s, 0, self.values[order]),
                   shape=(self.shape[1], self.shape[0]), nnz=self.nnz)

    def conj_transpose(self):
        t = self.transpose()
        return Coo(row_idx=t.row_idx, col_idx=t.col_idx,
                   values=t.values.conj_physical(), shape=t.shape,
                   nnz=t.nnz)

    def extract_diagonal(self):
        """Sum of the stored entries on the diagonal, on the matrix's
        device."""
        from .diagonal import Diagonal
        rows = self.row_idx[:self.nnz]
        cols = self.col_idx[:self.nnz]
        on_diag = rows == cols
        diag = torch.zeros(min(self.shape), dtype=self.values.dtype,
                           device=self.values.device)
        diag.index_add_(0, rows[on_diag], self.values[:self.nnz][on_diag])
        return Diagonal(diag)

    def compute_absolute(self):
        """|A| entrywise (AbsoluteComputable; abs over the value tensors)."""
        from ..base.linop import absolute_of_storage
        return absolute_of_storage(self)

    def to_matrix_data(self) -> MatrixData:
        from .csr import _values_numpy
        k = self.nnz
        return MatrixData(self.shape, self.row_idx[:k].cpu().numpy(),
                          self.col_idx[:k].cpu().numpy(),
                          _values_numpy(self.values[:k]))
