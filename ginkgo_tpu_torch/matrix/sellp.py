"""SELL-P (sliced ELLPACK) format (``ginkgo_tpu/matrix/sellp.py`` in
torch).

Analog of ``include/ginkgo/core/matrix/sellp.hpp:43`` (SELL-C-sigma family):
rows are grouped into slices of ``slice_size``; each slice is padded to ITS
OWN max row length rounded up to ``stride_factor`` — one long row only pads
its own slice, unlike ELL.  Storage is the flat per-slice-padded buffer
with slice offsets (Ginkgo's layout); without a banded or packed plan the
SpMV is the gather + ``index_add_`` of ``coo_spmv`` over the flat entries.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.linop import LinOp
from ..base.matrix_data import MatrixData
from ..device import resolve_device
from ..ops.registry import lookup
from .ell import row_positions


class Sellp(LinOp):
    def __init__(self, col_flat, val_flat, row_flat, shape, nnz,
                 slice_size=64, slice_offsets=(), slice_widths=(),
                 fast_op=None):
        self.col_flat = col_flat    # (total,) columns, slice-major padded
        self.val_flat = val_flat    # (total,) values, pad 0
        self.row_flat = row_flat    # (total,) owning row, pad n
        self.shape = tuple(shape)
        self.nnz = int(nnz)
        self.slice_size = int(slice_size)
        self.slice_offsets = tuple(slice_offsets)   # per-slice start
        self.slice_widths = tuple(slice_widths)     # per-slice stride
        self.fast_op = fast_op      # SpmvPlan fast path

    @property
    def num_slices(self):
        return len(self.slice_widths)

    @property
    def total_storage(self):
        return self.val_flat.shape[0]

    def _apply(self, b):
        if self.fast_op is not None:
            return self.fast_op._apply(b)
        return lookup("coo_spmv", b.device)(self.row_flat, self.col_flat,
                                            self.val_flat, b, self.shape[0])

    @classmethod
    def from_data(cls, data: MatrixData, dtype=None, index_dtype=torch.int32,
                  slice_size: int = 64, stride_factor: int = 8,
                  fast: bool = True, device=None):
        from .csr import _upload, host_value_types
        device = resolve_device(device)
        d = data.canonical()
        n, m = d.shape
        ss = int(slice_size)
        num_slices = max(1, -(-n // ss))
        row_ptr = d.row_ptrs()
        lengths = np.zeros(num_slices * ss, np.int64)
        lengths[:n] = np.diff(row_ptr)
        per_slice = lengths.reshape(num_slices, ss)
        widths = np.maximum(
            -(-per_slice.max(axis=1) // stride_factor) * stride_factor, 1)
        offsets = np.concatenate([[0], np.cumsum(widths * ss)])
        total = int(offsets[-1])
        vdtype, host = host_value_types(d.values.dtype, dtype)
        cols = np.zeros(total, np.int64)
        vals = np.zeros(total, host)
        rows = np.full(total, n, np.int64)
        if d.nnz:
            pos = row_positions(row_ptr)
            sl = d.row_idx // ss
            lr = d.row_idx - sl * ss
            flat = offsets[sl] + lr * widths[sl] + pos
            cols[flat] = d.col_idx
            vals[flat] = d.values
            rows[flat] = d.row_idx
        fast_op = None
        if fast and d.nnz:
            from .fastpath import plan_fast_spmv
            fast_op = plan_fast_spmv(d, dtype, index_dtype, device=device)
        return cls(col_flat=_upload(cols, device, index_dtype),
                   val_flat=_upload(vals, device, vdtype),
                   row_flat=_upload(rows, device, index_dtype),
                   shape=(n, m), nnz=d.nnz, slice_size=ss,
                   slice_offsets=offsets[:-1].tolist(),
                   slice_widths=widths.tolist(),
                   fast_op=fast_op)

    def to_dense(self):
        n, m = self.shape
        out = torch.zeros((n + 1, m), dtype=self.val_flat.dtype,
                          device=self.val_flat.device)
        out.index_put_((self.row_flat.long(), self.col_flat.long()),
                       self.val_flat, accumulate=True)
        return out[:n]

    def compute_absolute(self):
        """|A| entrywise (AbsoluteComputable; abs over the value tensors)."""
        from ..base.linop import absolute_of_storage
        return absolute_of_storage(self)

    def to_matrix_data(self) -> MatrixData:
        from .csr import _values_numpy
        rows = self.row_flat.cpu().numpy()
        keep = rows < self.shape[0]
        vals = _values_numpy(self.val_flat)[keep]
        nz = vals != 0
        return MatrixData(self.shape, rows[keep][nz],
                          self.col_flat.cpu().numpy()[keep][nz],
                          vals[nz]).sort_row_major()

    def to_csr(self, **kwargs):
        from .csr import Csr
        kwargs.setdefault("device", self.val_flat.device)
        return Csr.from_data(self.to_matrix_data(), **kwargs)
