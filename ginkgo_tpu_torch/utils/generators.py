"""Test/benchmark matrix generators.

Analogs of Ginkgo's ``benchmark/utils/stencil_matrix.hpp`` (5/7/9/27-point
stencils) and ``core/utils/matrix_utils.hpp`` / ``gko::test::generate_random_matrix``.
All host-side numpy (assembly-time work); a copy of
``ginkgo_tpu/utils/generators.py`` plus ``permute_locally``.
"""

from __future__ import annotations

import numpy as np

from ..base.matrix_data import MatrixData


def stencil_2d(nx: int, ny: int | None = None, *, points: int = 5,
               dtype=np.float64) -> MatrixData:
    """5- or 9-point 2D Laplacian stencil on an nx x ny grid (Dirichlet)."""
    ny = ny if ny is not None else nx
    if points not in (5, 9):
        raise ValueError("2D stencil must have 5 or 9 points")
    offs = ([(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)] if points == 5 else
            [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)])
    return _stencil(offs, (nx, ny), dtype)


def stencil_3d(nx: int, ny: int | None = None, nz: int | None = None, *,
               points: int = 7, dtype=np.float64) -> MatrixData:
    """7- or 27-point 3D Laplacian stencil (Dirichlet). The 27-point variant
    is the reference's headline benchmark config (BASELINE.md)."""
    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx
    if points == 7:
        offs = [(0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                (0, 0, -1), (0, 0, 1)]
    elif points == 27:
        offs = [(di, dj, dk) for di in (-1, 0, 1) for dj in (-1, 0, 1)
                for dk in (-1, 0, 1)]
    else:
        raise ValueError("3D stencil must have 7 or 27 points")
    return _stencil(offs, (nx, ny, nz), dtype)


def _stencil(offsets, dims, dtype) -> MatrixData:
    """Build a stencil matrix: diagonal = number of neighbors, off-diag = -1.
    Matches the diagonally-dominant SPD convention of the reference's
    stencil generator (center = num_points - 1 keeps rows weakly dominant)."""
    ndim = len(dims)
    n = int(np.prod(dims))
    grids = np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")
    coords = np.stack([g.ravel() for g in grids], axis=1)  # (n, ndim)
    strides = np.array([int(np.prod(dims[k + 1:])) for k in range(ndim)])

    rows_all, cols_all, vals_all = [], [], []
    num_points = len(offsets)
    for off in offsets:
        off = np.asarray(off)
        nb = coords + off
        valid = np.all((nb >= 0) & (nb < np.asarray(dims)), axis=1)
        r = np.nonzero(valid)[0]
        c = (nb[valid] * strides).sum(axis=1)
        is_center = not np.any(off)
        v = np.full(r.shape[0], (num_points - 1) if is_center else -1.0, dtype)
        rows_all.append(r)
        cols_all.append(c)
        vals_all.append(v)

    rows = np.concatenate(rows_all).astype(np.int32)
    cols = np.concatenate(cols_all).astype(np.int32)
    vals = np.concatenate(vals_all)
    return MatrixData((n, n), rows, cols, vals).sort_row_major()


def generate_random_matrix(num_rows: int, num_cols: int, *,
                           nonzeros_per_row=(1, None), dtype=np.float64,
                           seed: int = 0, value_range=(-1.0, 1.0),
                           ensure_diag: bool = False) -> MatrixData:
    """Random matrix with per-row nnz uniform in [lo, hi]
    (``gko::test::generate_random_matrix`` analog)."""
    rng = np.random.default_rng(seed)
    lo, hi = nonzeros_per_row
    hi = hi if hi is not None else max(1, num_cols // 2)
    hi = min(hi, num_cols)
    lo = min(lo, hi)
    rows, cols = [], []
    for r in range(num_rows):
        k = int(rng.integers(lo, hi + 1))
        c = rng.choice(num_cols, size=k, replace=False)
        rows.append(np.full(k, r, np.int32))
        cols.append(c.astype(np.int32))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        vals = (rng.uniform(*value_range, rows.size)
                + 1j * rng.uniform(*value_range, rows.size)).astype(dtype)
    else:
        vals = rng.uniform(*value_range, rows.size).astype(dtype)
    data = MatrixData((num_rows, num_cols), rows, cols, vals)
    if ensure_diag:
        n = min(num_rows, num_cols)
        didx = np.arange(n, dtype=np.int32)
        dvals = (hi + 1.0) * np.ones(n, dtype)  # diagonally dominant
        data = MatrixData((num_rows, num_cols),
                          np.concatenate([data.row_idx, didx]),
                          np.concatenate([data.col_idx, didx]),
                          np.concatenate([data.values, dvals]))
    return data.canonical()


def make_spd(data: MatrixData, shift: float = 1.0) -> MatrixData:
    """Symmetrize + diagonal shift: A := (A + A^T)/2 + shift*rowsum*I
    (``gko::utils::make_hpd`` analog)."""
    sym = MatrixData(data.shape,
                     np.concatenate([data.row_idx, data.col_idx]),
                     np.concatenate([data.col_idx, data.row_idx]),
                     np.concatenate([data.values, np.conj(data.values)]) / 2)
    sym = sym.canonical()
    rowsum = np.zeros(data.shape[0], np.abs(sym.values).dtype)
    np.add.at(rowsum, sym.row_idx, np.abs(sym.values))
    n = data.shape[0]
    didx = np.arange(n, dtype=sym.row_idx.dtype)
    return MatrixData(data.shape,
                      np.concatenate([sym.row_idx, didx]),
                      np.concatenate([sym.col_idx, didx]),
                      np.concatenate([sym.values,
                                      (shift * rowsum + shift).astype(sym.values.dtype)])
                      ).canonical()


def permute_locally(data: MatrixData, run: int = 256,
                    seed: int = 0) -> MatrixData:
    """Symmetric permutation P A Pᵀ that shuffles rows only inside each run
    of ``run`` consecutive rows (``numpy.random.default_rng(seed)``).

    Stands for an unstructured mesh whose numbering keeps locality (as
    after RCM or nested dissection): the diagonals of a stencil scatter,
    so the banded layout no longer fits, while every row's columns stay
    within a window the packed layout covers.  SPD stays SPD.  The row
    count must be a multiple of ``run``."""
    n = data.shape[0]
    if data.shape[1] != n or n % run:
        raise ValueError(f"need a square matrix with rows a multiple of "
                         f"{run}, got {data.shape}")
    rng = np.random.default_rng(seed)
    perm = rng.permuted(np.arange(n).reshape(-1, run), axis=1).ravel()
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    return MatrixData(data.shape, inv[data.row_idx], inv[data.col_idx],
                      data.values).canonical()
