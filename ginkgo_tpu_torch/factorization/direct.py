"""Sparse direct factorizations with fill-in: LU and Cholesky
(``ginkgo_tpu/factorization/direct.py`` in torch).

Analog of ``include/ginkgo/core/factorization/lu.hpp:54`` /
``cholesky.hpp:35`` (``core/factorization/{lu,cholesky}.cpp``,
``elimination_forest.cpp``, ``symbolic.cpp``).

Symbolic + numeric both run at generate time on the host (like Ginkgo's
symbolic phase; factorization is a setup-cost activity), producing static
L/U Csr factors on A's device (the CUDA device for plain MatrixData),
whose *solves* run there through the triangular solves.  The native C++
tier factors first; without it the numeric kernel is an IKJ row
elimination over dict-of-rows with on-the-fly fill — O(flops of the
factorization).
"""

from __future__ import annotations

import collections

import numpy as np

from ..base.matrix_data import MatrixData
from ..matrix.csr import Csr
from ..native import chol_factor_native, lu_factor_native
from ..device import matrix_data_and_device
from .container import Factorization


def _rows_dict(d: MatrixData):
    rows = [dict() for _ in range(d.shape[0])]
    for i, j, v in zip(d.row_idx, d.col_idx, d.values):
        rows[int(i)][int(j)] = rows[int(i)].get(int(j), 0) + v
    return rows


def _collect(rows, pred):
    r, c, v = [], [], []
    for i, row in enumerate(rows):
        for j, val in row.items():
            if pred(i, j) and val != 0:
                r.append(i)
                c.append(j)
                v.append(val)
    return (np.asarray(r, np.int64), np.asarray(c, np.int64), v)


def _classical(data, device):
    return Csr.from_data(data, strategy="classical", device=device)


def _lu_factorization(n, lower, upper, dtype, device):
    """Factors from the strict lower (lr, lc, lv) and upper (ur, uc, uv)
    triplets: L takes a unit diagonal."""
    (lr, lc, lv), (ur, uc, uv) = lower, upper
    diag = np.arange(n)
    l_data = MatrixData((n, n), np.concatenate([lr, diag]),
                        np.concatenate([lc, diag]),
                        np.concatenate([np.asarray(lv, dtype),
                                        np.ones(n, dtype)]))
    u_data = MatrixData((n, n), ur, uc, np.asarray(uv, dtype))
    return Factorization(l_factor=_classical(l_data, device),
                         u_factor=_classical(u_data, device))


def _chol_factorization(n, lower, dtype, device):
    """L from its (lr, lc, lv) triplets, and Lᴴ."""
    lr, lc, lv = lower
    l_data = MatrixData((n, n), lr, lc,
                        np.asarray(lv, dtype)).sort_row_major()
    return Factorization(
        l_factor=_classical(l_data, device),
        u_factor=_classical(l_data.conj_transpose().sort_row_major(),
                            device),
        symmetric=True)


class Lu:
    """Sparse LU with fill (no pivoting, like Ginkgo's Lu — reorder/scale
    first via Mc64/ScaledReordered for stability)."""

    def __init__(self, symbolic_algorithm: str = "general"):
        self.symbolic_algorithm = symbolic_algorithm

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> Factorization:
        data, device = matrix_data_and_device(A)
        d = data.canonical()
        n = d.shape[0]
        native = lu_factor_native(n, d.row_idx, d.col_idx, d.values)
        if native is not None:
            return _lu_factorization(n, *native, d.values.dtype, device)
        rows = _rows_dict(d)
        # column -> rows holding a (possibly fill) entry there, maintained
        # as fill appears, so elimination cost tracks actual nnz+fill
        col_rows = collections.defaultdict(set)
        for i, row in enumerate(rows):
            for j in row:
                col_rows[j].add(i)
        for k in range(n):
            dk = rows[k].get(k, 0)
            if dk == 0:
                rows[k][k] = dk = 1.0  # zero pivot guard
            urow = [(j, v) for j, v in rows[k].items() if j > k]
            for i in sorted(col_rows[k]):
                if i <= k:
                    continue
                ri = rows[i]
                aik = ri.get(k)
                if aik is None or aik == 0:
                    continue
                lik = aik / dk
                ri[k] = lik
                for j, ukj in urow:
                    if j in ri:
                        ri[j] -= lik * ukj
                    else:
                        ri[j] = -lik * ukj
                        col_rows[j].add(i)
        return _lu_factorization(n, _collect(rows, lambda i, j: j < i),
                                 _collect(rows, lambda i, j: j >= i),
                                 d.values.dtype, device)


class Cholesky:
    """Sparse Cholesky with fill (elimination-forest symbolic folded into
    the up-looking numeric pass)."""

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> Factorization:
        data, device = matrix_data_and_device(A)
        d = data.canonical()
        n = d.shape[0]
        native = chol_factor_native(n, d.row_idx, d.col_idx, d.values)
        if native is not None:
            return _chol_factorization(n, native, d.values.dtype, device)
        # work on the lower triangle, column-oriented left-looking; a
        # row->finalized-columns index keeps cost at O(nnz + fill) instead
        # of scanning all previous columns per j (the Lu col_rows trick)
        cols = [dict() for _ in range(n)]   # cols[j][i] = L[i, j], i >= j
        row_cols = [[] for _ in range(n)]   # row j -> columns k<j, L[j,k]!=0
        for i, j, v in zip(d.row_idx, d.col_idx, d.values):
            if i >= j:
                cols[int(j)][int(i)] = v
        for j in range(n):
            for k in row_cols[j]:
                ljk = cols[k].get(j)
                if ljk is None or ljk == 0:
                    continue
                for i, lik in cols[k].items():
                    if i >= j:
                        cols[j][i] = cols[j].get(i, 0) - lik * np.conj(ljk)
            djj = cols[j].get(j, 0)
            ljj = np.sqrt(abs(djj))
            if ljj == 0:
                ljj = 1.0
            cols[j][j] = ljj
            for i in list(cols[j]):
                if i > j:
                    cols[j][i] = cols[j][i] / ljj
                    row_cols[i].append(j)   # column j is now finalized
        r, c, v = [], [], []
        for j in range(n):
            for i, val in cols[j].items():
                if val != 0:
                    r.append(i)
                    c.append(j)
                    v.append(val)
        return _chol_factorization(
            n, (np.asarray(r, np.int64), np.asarray(c, np.int64), v),
            d.values.dtype, device)
