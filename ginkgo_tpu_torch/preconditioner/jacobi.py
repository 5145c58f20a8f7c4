"""Jacobi preconditioner, scalar path (``ginkgo_tpu/preconditioner/jacobi.py``
in torch).

Analog of ``include/ginkgo/core/preconditioner/jacobi.hpp:187`` with
``max_block_size == 1``: invert the diagonal, optionally after L1 row-sum
augmentation (``scalar_l1``, jacobi.cpp:340-344).
"""

from __future__ import annotations

import torch

from ..base.dtypes import as_torch_dtype
from ..base.linop import LinOp
from ..matrix.diagonal import Diagonal


class Jacobi:
    """Factory: ``Jacobi().generate(A)`` -> Diagonal of inverse entries."""

    def __init__(self, max_block_size: int = 1, *, scalar_l1: bool = False,
                 storage_dtype=None):
        if max_block_size > 1:
            raise NotImplementedError(
                "block Jacobi (max_block_size > 1) needs the batched "
                "inverse of ginkgo_tpu/ops/gauss_jordan.py, which a later "
                "slice of the port brings (ROADMAP.md, queue 1: block "
                "Jacobi with gauss_jordan)")
        self.max_block_size = max_block_size
        self.scalar_l1 = scalar_l1
        self.storage_dtype = storage_dtype

    # keep Ginkgo's fluent spelling available
    @classmethod
    def build(cls, **kwargs):
        return cls(**kwargs)

    def generate(self, A) -> LinOp:
        diag = A.extract_diagonal().values
        if self.scalar_l1:
            # add off-diagonal row L1 mass to the diagonal
            row_abs = _row_abs_sum(A)
            diag = diag + (row_abs - torch.abs(diag))
        inv = torch.where(diag == 0, torch.ones_like(diag), 1.0 / diag)
        if self.storage_dtype is not None:
            inv = inv.to(as_torch_dtype(self.storage_dtype)).to(diag.dtype)
        return Diagonal(inv)


def _row_abs_sum(A):
    """Row sums of |A| over the stored entries of a Csr or Coo."""
    n = A.shape[0]
    out = torch.zeros(n + 1, dtype=torch.abs(A.values).dtype,
                      device=A.values.device)
    out.index_add_(0, A.row_idx, torch.abs(A.values))
    return out[:n]
