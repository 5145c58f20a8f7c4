"""Diagonal operator (``include/ginkgo/core/matrix/diagonal.hpp``).

Supports apply (scale rows), inverse_apply, rapply (scale columns), the
transposes and ``compute_absolute`` — used by scalar Jacobi and matrix
equilibration.  Every method runs on the values' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.dtypes import as_torch_dtype
from ..base.linop import LinOp, as_multivector
from ..base.matrix_data import MatrixData
from ..device import resolve_device


class Diagonal(LinOp):
    def __init__(self, values):
        self.values = values    # (n,)

    @property
    def shape(self):
        n = self.values.shape[0]
        return (n, n)

    def _apply(self, b):
        return self.values[:, None].to(b.dtype) * b

    def inverse_apply(self, b):
        b2, squeeze = as_multivector(b)
        out = b2 / self.values[:, None].to(b2.dtype)
        return out[:, 0] if squeeze else out

    def rapply(self, b):
        """Column scaling ``b @ D`` (``diagonal.hpp:151``): scales the j-th
        column of b by values[j]; b is (k, n) here."""
        return b * self.values[None, :].to(b.dtype)

    def inverse(self):
        return Diagonal(1.0 / self.values)

    def compute_absolute(self):
        return Diagonal(torch.abs(self.values))

    def conj_transpose(self):
        return Diagonal(self.values.conj_physical())

    def transpose(self):
        return self

    def to_dense(self):
        return torch.diag(self.values)

    @classmethod
    def from_data(cls, data: MatrixData, dtype=None, device=None):
        """The canonical diagonal of ``data`` (duplicates summed), placed
        on ``device`` (``None``: the CUDA device; raises when there is
        none)."""
        device = resolve_device(device)
        d = data.canonical()
        diag = np.zeros(min(d.shape), d.values.dtype)
        on_diag = d.row_idx == d.col_idx
        diag[d.row_idx[on_diag]] = d.values[on_diag]
        values = torch.from_numpy(diag).to(device)
        if dtype is not None:
            values = values.to(as_torch_dtype(dtype))
        return cls(values)
