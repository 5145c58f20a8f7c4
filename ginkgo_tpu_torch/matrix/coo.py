"""COO format (``include/ginkgo/core/matrix/coo.hpp:50``; the parts of
``ginkgo_tpu/matrix/coo.py`` the ported path uses).

Arrays are padded to ``nnz_stored >= nnz`` with ``row = num_rows, col = 0,
val = 0``; ``coo_spmv`` drops the ``num_rows`` row, so padding is inert.
"""

from __future__ import annotations

import torch

from ..base.linop import LinOp
from ..ops.registry import lookup


def pad_nnz(nnz: int, multiple: int) -> int:
    return max(multiple, -(-nnz // multiple) * multiple)


class Coo(LinOp):
    def __init__(self, row_idx, col_idx, values, shape, nnz):
        self.row_idx = row_idx      # (nnz_stored,) int
        self.col_idx = col_idx      # (nnz_stored,) int
        self.values = values        # (nnz_stored,)
        self.shape = tuple(shape)
        self.nnz = int(nnz)

    def _apply(self, b):
        return lookup("coo_spmv", b.device)(self.row_idx, self.col_idx,
                                            self.values, b, self.shape[0])

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

