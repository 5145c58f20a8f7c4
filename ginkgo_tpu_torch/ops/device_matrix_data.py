"""Device-side COO canonicalization
(``ginkgo_tpu/ops/device_matrix_data.py`` in torch).

Analog of the ``device_matrix_data`` kernels
(``core/base/device_matrix_data_kernels.hpp:22-52``: sort_row_major,
sum_duplicates, remove_zeros) on the tensors' device: all outputs keep the
input's static capacity, with padding entries (row = num_rows, val = 0)
that every downstream kernel already treats as inert.  Device-built
triplets can be canonicalized and consumed without a host round trip.
"""

from __future__ import annotations

import copy

import torch


def sort_row_major(rows, cols, vals, num_rows, num_cols):
    """Stable sort by (row, col); padding (row >= num_rows) sorts last.
    Two stable argsorts (lexsort), the reference's order bit for bit."""
    order1 = torch.argsort(cols, stable=True)
    primary = torch.clamp(rows, max=num_rows)[order1]
    order = order1[torch.argsort(primary, stable=True)]
    return rows[order], cols[order], vals[order]


def sum_duplicates(rows, cols, vals, num_rows, num_cols):
    """Combine duplicate (row, col) entries (static capacity): the result
    is row-major sorted, deduplicated, padded at the tail; also returns
    the nnz as a 0-d tensor."""
    rows, cols, vals = sort_row_major(rows, cols, vals, num_rows, num_cols)
    valid = rows < num_rows
    same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
    is_new = torch.cat([valid[:1], (~same) & valid[1:]])
    # destination slot of each entry = (#new groups before it) - 1
    slot = torch.cumsum(is_new.to(torch.int64), 0) - 1
    cap = rows.shape[0]
    dest = torch.where(valid, slot, cap)
    out_vals = vals.new_zeros(cap + 1).index_add_(0, dest, vals)[:cap]
    head = torch.where(is_new, slot, cap)
    out_rows = rows.new_full((cap + 1,), num_rows)
    out_rows[head] = torch.where(is_new, rows, num_rows)
    out_cols = cols.new_zeros(cap + 1)
    out_cols[head] = torch.where(is_new, cols, 0)
    nnz = is_new.sum(dtype=torch.int32)
    return out_rows[:cap], out_cols[:cap], out_vals, nnz


def remove_zeros(rows, cols, vals, num_rows):
    """Turn explicit zeros into padding (capacity preserved)."""
    zero = vals == 0
    return (torch.where(zero, num_rows, rows),
            torch.where(zero, 0, cols), vals)


def canonicalize_device(coo):
    """Full device canonicalization of a Coo operator (returns a new Coo
    with the same capacity; padded tail inert).

    Order matches MatrixData.canonical(): duplicates are summed FIRST so
    entries that cancel to zero are removed (a second dedup pass compacts
    the holes left by zero removal — it is a no-op on the values since no
    duplicates remain)."""
    n, m = coo.shape
    r, c, v = coo.row_idx, coo.col_idx, coo.values
    r, c, v, _ = sum_duplicates(r, c, v, n, m)
    r, c, v = remove_zeros(r, c, v, n)
    r, c, v, nnz = sum_duplicates(r, c, v, n, m)
    out = copy.copy(coo)
    out.row_idx, out.col_idx, out.values = r, c, v
    out.nnz = int(nnz)
    return out
