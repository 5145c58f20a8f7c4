"""Diagonal operator (``include/ginkgo/core/matrix/diagonal.hpp``).

Supports apply (scale rows) and inverse_apply — used by scalar Jacobi.
"""

from __future__ import annotations

import torch

from ..base.linop import LinOp, as_multivector


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

    def inverse(self):
        return Diagonal(1.0 / self.values)

    def to_dense(self):
        return torch.diag(self.values)
