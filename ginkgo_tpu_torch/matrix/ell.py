"""ELL format (``include/ginkgo/core/matrix/ell.hpp:52``;
``ginkgo_tpu/matrix/ell.py`` in torch).

Fixed nnz-per-row padded layout: (n, width) value/column planes, padded
slots carrying col=0/val=0 and masked by the row lengths.  ``from_data``
also plans the kept entries into the banded or packed layout
(``matrix/fastpath.py``) when one is economical, and then applies through
kernel A or B; otherwise the apply is the plain gather ``ell_spmv``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.linop import LinOp
from ..base.matrix_data import MatrixData
from ..device import resolve_device
from ..ops.registry import lookup


def row_positions(row_ptr) -> np.ndarray:
    """Position of each entry within its row, for row-major entries with
    row pointers ``row_ptr``: ``np.concatenate([np.arange(l) for l in
    lengths])`` without the loop over rows."""
    row_ptr = np.asarray(row_ptr, np.int64)
    lengths = np.diff(row_ptr)
    return np.arange(int(row_ptr[-1])) - np.repeat(row_ptr[:-1], lengths)


class Ell(LinOp):
    def __init__(self, col_idx, values, row_lengths, shape, nnz,
                 fast_op=None):
        self.col_idx = col_idx          # (n, width) int, padded with 0
        self.values = values            # (n, width), padded with 0
        self.row_lengths = row_lengths  # (n,) int
        self.shape = tuple(shape)
        self.nnz = int(nnz)
        self.fast_op = fast_op          # SpmvPlan fast path

    @property
    def width(self):
        return self.values.shape[1]

    def _mask(self):
        return (torch.arange(self.width, device=self.values.device)[None, :]
                < self.row_lengths[:, None])

    def _apply(self, b):
        if self.fast_op is not None:
            return self.fast_op._apply(b)
        return lookup("ell_spmv", b.device)(self.col_idx.long(), self.values,
                                            b, self._mask())

    @classmethod
    def from_data(cls, data: MatrixData, dtype=None, index_dtype=torch.int32,
                  width: int | None = None, allow_truncate: bool = False,
                  fast: bool = True, device=None):
        from .csr import _upload, host_value_types
        device = resolve_device(device)
        d = data.canonical()
        n, m = d.shape
        row_ptr = d.row_ptrs()
        lengths = np.diff(row_ptr)
        w = int(lengths.max()) if width is None and d.nnz else width
        w = max(w if w is not None else 1, 1)
        if (not allow_truncate and d.nnz
                and int(lengths.max()) > w):
            raise ValueError(
                f"row with {int(lengths.max())} entries exceeds the imposed "
                f"ELL width {w} (pass allow_truncate=True to drop overflow)")
        vdtype, host = host_value_types(d.values.dtype, dtype)
        cols = np.zeros((n, w), np.int64)
        vals = np.zeros((n, w), host)
        pos = row_positions(row_ptr)
        keep = pos < w
        cols[d.row_idx[keep], pos[keep]] = d.col_idx[keep]
        vals[d.row_idx[keep], pos[keep]] = d.values[keep]
        fast_op = None
        if fast:
            from .fastpath import plan_fast_spmv
            kept = MatrixData((n, m), d.row_idx[keep], d.col_idx[keep],
                              d.values[keep])
            fast_op = plan_fast_spmv(kept, dtype, index_dtype, device=device)
        return cls(col_idx=_upload(cols, device, index_dtype),
                   values=_upload(vals, device, vdtype),
                   row_lengths=_upload(np.minimum(lengths, w), device,
                                       index_dtype),
                   shape=(n, m), nnz=int(keep.sum()), fast_op=fast_op)

    def to_dense(self):
        n, m = self.shape
        rows = torch.arange(n, device=self.values.device)[:, None].expand(
            self.col_idx.shape)
        out = torch.zeros((n, m), dtype=self.values.dtype,
                          device=self.values.device)
        out.index_put_((rows, self.col_idx.long()),
                       torch.where(self._mask(), self.values, 0),
                       accumulate=True)
        return out

    def to_csr(self, **kwargs):
        from .csr import Csr
        kwargs.setdefault("device", self.values.device)
        return Csr.from_data(self.to_matrix_data(), **kwargs)

    def compute_absolute(self):
        """|A| entrywise (AbsoluteComputable; abs over the value tensors)."""
        from ..base.linop import absolute_of_storage
        return absolute_of_storage(self)

    def to_matrix_data(self) -> MatrixData:
        from .csr import _values_numpy
        cols = self.col_idx.cpu().numpy()
        vals = _values_numpy(self.values)
        lens = self.row_lengths.cpu().numpy()
        mask = np.arange(self.width)[None, :] < lens[:, None]
        r, c = np.nonzero(mask)
        return MatrixData(self.shape, r.astype(np.int32), cols[r, c],
                          vals[r, c]).sort_row_major()
