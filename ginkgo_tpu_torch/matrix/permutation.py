"""Permutation and ScaledPermutation operators
(``ginkgo_tpu/matrix/permutation.py`` in torch).

Analog of ``include/ginkgo/core/matrix/permutation.hpp:111`` /
``scaled_permutation.hpp:36``.  ``permute_mode`` mirrors Ginkgo's enum:
rows / columns / symmetric (x) inverse variants.  On the device a
permutation is a gather; ``permute_data``/``scale_permute_data`` remap a
matrix's triplets on the host (``Csr.permute``, ``Csr.scale_permute``).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..base.linop import LinOp
from ..device import resolve_device


class permute_mode(enum.Flag):
    none = 0
    rows = 1
    columns = 2
    inverse = 4
    symmetric = rows | columns
    inverse_rows = inverse | rows
    inverse_columns = inverse | columns
    inverse_symmetric = inverse | rows | columns


def _invert_perm(perm):
    """Inverse of a permutation vector; numpy arrays and tensors both
    work."""
    if isinstance(perm, torch.Tensor):
        inv = torch.empty_like(perm)
        inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                        device=perm.device)
        return inv
    inv = np.zeros_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def _on_device(arr, device, dtype=None):
    if isinstance(arr, torch.Tensor):
        t = arr
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))
    return t.to(device=device, dtype=dtype)


class Permutation(LinOp):
    """x = b[perm]: row-permutation as a LinOp."""

    def __init__(self, perm):
        self.perm = perm    # (n,) destination row i takes source row perm[i]

    @property
    def shape(self):
        n = self.perm.shape[0]
        return (n, n)

    def _apply(self, b):
        return b[self.perm.long()]

    def inverse(self):
        return Permutation(_invert_perm(self.perm))

    def transpose(self):
        return self.inverse()

    def conj_transpose(self):
        return self.inverse()

    def to_dense(self):
        n = self.perm.shape[0]
        out = torch.zeros((n, n), dtype=torch.float64,
                          device=self.perm.device)
        out[torch.arange(n, device=self.perm.device), self.perm.long()] = 1.0
        return out

    @classmethod
    def from_indices(cls, perm, index_dtype=torch.int32, device=None):
        return cls(_on_device(perm, resolve_device(device), index_dtype))


class ScaledPermutation(LinOp):
    """x = scale * b[perm] (``scaled_permutation.hpp:36``)."""

    def __init__(self, perm, scale):
        self.perm = perm
        self.scale = scale  # (n,)

    @property
    def shape(self):
        n = self.perm.shape[0]
        return (n, n)

    def _apply(self, b):
        return self.scale[:, None].to(b.dtype) * b[self.perm.long()]

    def inverse(self):
        inv = _invert_perm(self.perm)
        inv_scale = (1.0 / self.scale)[inv.long()]
        return ScaledPermutation(inv, inv_scale)

    def to_dense(self):
        n = self.perm.shape[0]
        out = torch.zeros((n, n), dtype=self.scale.dtype,
                          device=self.scale.device)
        out[torch.arange(n, device=self.perm.device),
            self.perm.long()] = self.scale
        return out

    @classmethod
    def from_indices(cls, perm, scale, index_dtype=torch.int32, device=None):
        device = resolve_device(device)
        return cls(_on_device(perm, device, index_dtype),
                   _on_device(scale, device))


def _host(arr):
    return arr.cpu().numpy() if isinstance(arr, torch.Tensor) \
        else np.asarray(arr)


def scale_permute_data(data, row_sp, mode: permute_mode = None,
                       col_sp=None, invert: bool = False):
    """Host-side scaled permutation of a matrix (``dense.hpp:505-560``,
    ``csr.hpp`` scale_permute).  ``row_sp``/``col_sp``: ScaledPermutation
    operators or (perm, scale) tuples.

    One-permutation form (``col_sp=None``): applies ``mode`` with
    S = diag(scale)·P — rows: A' = S A; columns: A' = A Sᵀ; symmetric:
    A' = S A Sᵀ; with ``permute_mode.inverse`` the inverse S⁻¹ is used.
    Two-permutation form: A' = S_r A S_cᵀ (or their inverses when
    ``invert``)."""
    from ..base.matrix_data import MatrixData

    (rp, rs), (cp, cs), do_rows, do_cols, inv_flag = \
        _normalize_scale_permute(row_sp, mode, col_sp, invert)

    r = data.row_idx.copy()
    c = data.col_idx.copy()
    v = data.values.copy()
    if do_rows:
        if inv_flag:
            # A' = S⁻¹ A: row j of A lands on row p[j], scaled by 1/s[j]
            v = v / rs[r]
            r = rp[r]
        else:
            # A'(i, :) = s[i] * A(p[i], :): row r lands on inv[r]
            r = _invert_perm(rp)[r]
            v = v * rs[r]
    if do_cols:
        if inv_flag:
            # A' = A S⁻ᵀ: column k of A lands on column p[k], scaled 1/s[k]
            v = v / cs[c]
            c = cp[c]
        else:
            # A' = A Sᵀ: A'(:, j) = A(:, p[j]) * s[j]
            c = _invert_perm(cp)[c]
            v = v * cs[c]
    return MatrixData(data.shape, r, c, v).sort_row_major()


def _normalize_scale_permute(row_sp, mode, col_sp, invert):
    """Shared argument normalization for the scale_permute overloads.
    Returns ((rp, rs), (cp, cs), do_rows, do_cols, inv_flag) as host
    arrays.  ``mode`` belongs to the one-permutation form only — passing it
    together with ``col_sp`` is a conflict and raises."""

    def _unpack(sp):
        if sp is None:
            return None, None
        p, s = sp if isinstance(sp, tuple) else (sp.perm, sp.scale)
        return _host(p), _host(s)

    rp, rs = _unpack(row_sp)
    if col_sp is not None:
        if mode is not None:
            raise ValueError(
                "scale_permute: pass either mode (one-permutation form) "
                "or col_sp (row/col pair form), not both")
        cp, cs = _unpack(col_sp)
        return (rp, rs), (cp, cs), True, True, invert
    if mode is None:
        mode = permute_mode.symmetric
    do_rows = bool(mode & permute_mode.rows)
    do_cols = bool(mode & permute_mode.columns)
    inv_flag = bool(mode & permute_mode.inverse) or invert
    return (rp, rs), (rp, rs), do_rows, do_cols, inv_flag


def permute_data(data, perm: np.ndarray, mode: permute_mode):
    """Host-side matrix permutation (Ginkgo's Csr::permute): returns new
    MatrixData with rows/cols remapped.  ``perm`` as in Permutation: output
    row i = input row perm[i]."""
    from ..base.matrix_data import MatrixData
    perm = _host(perm)
    inv = _invert_perm(perm)
    r, c = data.row_idx.copy(), data.col_idx.copy()
    row_map = perm if (mode & permute_mode.inverse) else inv
    col_map = row_map
    if mode & permute_mode.rows:
        r = row_map[r]
    if mode & permute_mode.columns:
        c = col_map[c]
    return MatrixData(data.shape, r, c, data.values).sort_row_major()
