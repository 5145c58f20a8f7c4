"""csr_lookup — per-row column -> value-index lookup
(``ginkgo_tpu/matrix/csr_lookup.py`` in torch).

Analog of ``core/matrix/csr_lookup.hpp:26-57`` (sparsity_type full / bitmap /
hash): factorizations and SpGEMM-reuse need O(1) "where is column j in row
i" queries.  Host-side build; the device representation is a padded dense
(n, max_row_nnz) column table searched row by row (every row's columns
are sorted in canonical CSR), in place of the reference's per-row hash
tables.
"""

from __future__ import annotations

import numpy as np
import torch

from .ell import row_positions


class CsrLookup:
    def __init__(self, cols_padded, base, lengths, num_cols=0):
        self.cols_padded = cols_padded  # (n, w) sorted columns, padded with m
        self.base = base                # (n,) first value index of each row
        self.lengths = lengths          # (n,)
        self.num_cols = int(num_cols)

    @classmethod
    def build(cls, csr) -> "CsrLookup":
        """The table of ``csr`` (any operator with ``to_matrix_data``), on
        its device."""
        d = csr.to_matrix_data()
        n, m = d.shape
        ptr = d.row_ptrs()
        lengths = np.diff(ptr)
        w = max(1, int(lengths.max()) if n else 1)
        cols = np.full((n, w), m, np.int64)
        cols[d.row_idx, row_positions(ptr)] = d.col_idx
        dev = csr.device
        return cls(cols_padded=torch.from_numpy(cols).to(dev),
                   base=torch.from_numpy(ptr[:-1]).to(dev),
                   lengths=torch.from_numpy(lengths).to(dev), num_cols=m)

    def lookup(self, rows, cols):
        """Value index of entry (row, col); -1 when absent.  Vectorised
        over the queries."""
        dev = self.base.device
        rows = torch.as_tensor(rows, device=dev).long()
        cols = torch.as_tensor(cols, device=dev).long()
        table = self.cols_padded[rows]                   # (k, w)
        pos = searchsorted_rows(table, cols)
        hit = (pos < self.lengths[rows]) & (
            torch.take_along_dim(table, pos[:, None].clamp(
                max=table.shape[1] - 1), 1)[:, 0] == cols)
        return torch.where(hit, self.base[rows] + pos, -1)


def searchsorted_rows(table, keys):
    """Per-row searchsorted: table (k, w) sorted rows, keys (k,)."""
    return torch.sum(table < keys[:, None], dim=1)
