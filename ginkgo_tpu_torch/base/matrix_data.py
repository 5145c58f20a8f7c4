"""Host-side COO assembly container.

TPU-native analog of Ginkgo's ``matrix_data`` / ``device_matrix_data``
(``include/ginkgo/core/base/matrix_data.hpp``, ``device_matrix_data.hpp``;
kernels ``core/base/device_matrix_data_kernels.hpp:22-52``: sort_row_major,
sum_duplicates, remove_zeros).  Assembly is a *build-time* activity with
dynamic sizes, so it lives on the host in numpy — the device tiers only ever
see the static-shaped format arrays produced from it.  This mirrors the
reference's split between host ``matrix_data`` (AoS, flexible) and device
formats (static, tuned).  A copy of ``ginkgo_tpu/base/matrix_data.py``:
the port imports nothing of the JAX package.

ALIASING CONTRACT: ``sort_row_major`` / ``sum_duplicates`` /
``remove_zeros`` / ``canonical`` MAY return ``self`` (and therefore
*views of the caller's arrays*) when the data is already in the target
state.  Treat every MatrixData result as IMMUTABLE.  Any code that
mutates arrays in place (``arr[:] = ...``, native in-place kernels such
as ``gt_ilu0``/``gt_ic0``) must first take an explicit copy
(``np.array(x, copy=True)``); ``x.astype(dt)`` and fancy indexing
``x[mask]`` also always copy.  Violating this silently corrupts the
user's operator (the round-2 Ilu0 regression).  The no-mutation gate
``tests/test_no_mutation.py`` enforces this for every factory/solver.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass
class MatrixData:
    """COO triplets + shape. Always held in structure-of-arrays numpy form."""

    shape: tuple[int, int]
    row_idx: np.ndarray  # (nnz,) integer
    col_idx: np.ndarray  # (nnz,) integer
    values: np.ndarray   # (nnz,) value dtype

    def __post_init__(self):
        self.row_idx = np.asarray(self.row_idx)
        self.col_idx = np.asarray(self.col_idx)
        self.values = np.asarray(self.values)
        if not (self.row_idx.shape == self.col_idx.shape == self.values.shape):
            raise ValueError("row/col/values must have matching shapes")

    # -- construction -----------------------------------------------------
    @classmethod
    def empty(cls, shape, dtype=np.float64, index_dtype=np.int32):
        z = np.zeros(0, dtype)
        zi = np.zeros(0, index_dtype)
        return cls(shape, zi, zi.copy(), z)

    @classmethod
    def from_dense(cls, dense: np.ndarray, drop_tol: float = 0.0):
        dense = np.asarray(dense)
        mask = np.abs(dense) > drop_tol
        r, c = np.nonzero(mask)
        return cls(dense.shape, r.astype(np.int32), c.astype(np.int32),
                   dense[r, c])

    @classmethod
    def diag(cls, diag_values: np.ndarray):
        diag_values = np.asarray(diag_values)
        n = diag_values.shape[0]
        idx = np.arange(n, dtype=np.int32)
        return cls((n, n), idx, idx.copy(), diag_values)

    # -- canonicalisation (device_matrix_data_kernels analogs) -------------
    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    def _keys(self) -> np.ndarray:
        """(row, col) fused into one sortable int64 key per entry.
        Requires rows*cols < 2**63 (host-assembly sizes are far below)."""
        return self.row_idx.astype(np.int64) * self.shape[1] + self.col_idx

    def sort_row_major(self) -> "MatrixData":
        """Stable sort by (row, col) — ``sort_row_major`` kernel analog.
        Already-sorted inputs (the common case for data that round-trips
        through a format's ``to_matrix_data``) return self in one pass."""
        keys = self._keys()
        if keys.size == 0 or bool(np.all(keys[1:] >= keys[:-1])):
            return self
        order = np.argsort(keys, kind="stable")
        return MatrixData(self.shape, self.row_idx[order],
                          self.col_idx[order], self.values[order])

    def sum_duplicates(self) -> "MatrixData":
        """Combine duplicate (row, col) entries — ``sum_duplicates`` analog.
        Large f64/c128 inputs take the C++ native kernel; everything else
        the numpy path (both produce canonical row-major order).  Sorted
        duplicate runs are reduced with ``np.add.reduceat`` — no second
        sort (np.unique) and no buffered-ufunc ``np.add.at`` scatter."""
        if self.nnz == 0:
            return self.sort_row_major()
        if (self.nnz >= 1 << 16
                and self.values.dtype in (np.float64, np.complex128)):
            from ..native import coo_canonicalize_native
            out = coo_canonicalize_native(self.row_idx, self.col_idx,
                                          self.values)
            if out is not None:
                r, c, v = out
                return MatrixData(self.shape,
                                  r.astype(self.row_idx.dtype),
                                  c.astype(self.col_idx.dtype),
                                  v.astype(self.values.dtype))
        d = self.sort_row_major()
        keys = d._keys()
        first = np.empty(keys.shape[0], bool)
        first[0] = True
        np.not_equal(keys[1:], keys[:-1], out=first[1:])
        if first.all():
            return d
        starts = np.flatnonzero(first)
        values = np.add.reduceat(d.values, starts)
        return MatrixData(self.shape, d.row_idx[starts], d.col_idx[starts],
                          values)

    def remove_zeros(self) -> "MatrixData":
        mask = self.values != 0
        if mask.all():
            return self
        return MatrixData(self.shape, self.row_idx[mask], self.col_idx[mask],
                          self.values[mask])

    def canonical(self) -> "MatrixData":
        """sum_duplicates + remove_zeros + row-major order — the state every
        format's ``read`` expects (``core/matrix/csr.cpp`` read path)."""
        return self.sum_duplicates().remove_zeros()

    # -- dense conversion (tests/oracle) ------------------------------------
    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, self.values.dtype)
        np.add.at(out, (self.row_idx, self.col_idx), self.values)
        return out

    # -- transformations ----------------------------------------------------
    def transpose(self) -> "MatrixData":
        return MatrixData((self.shape[1], self.shape[0]), self.col_idx,
                          self.row_idx, self.values)

    def conj_transpose(self) -> "MatrixData":
        t = self.transpose()
        return MatrixData(t.shape, t.row_idx, t.col_idx, np.conj(t.values))

    def astype(self, dtype) -> "MatrixData":
        return MatrixData(self.shape, self.row_idx, self.col_idx,
                          self.values.astype(dtype))

    def filter(self, pred: Callable[[np.ndarray, np.ndarray, np.ndarray],
                                    np.ndarray]) -> "MatrixData":
        mask = pred(self.row_idx, self.col_idx, self.values)
        return MatrixData(self.shape, self.row_idx[mask], self.col_idx[mask],
                          self.values[mask])

    # row_ptr for CSR builds
    def row_ptrs(self) -> np.ndarray:
        counts = np.bincount(self.row_idx, minlength=self.shape[0])
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
