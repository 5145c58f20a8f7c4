"""Sparse matrix-vector products, reference tier
(``ginkgo_tpu/ops/spmv.py`` in torch).

Conventions: multivectors are (n, k); padded COO entries carry
``col = 0, val = 0, row = num_rows`` and land in a scratch row that is
sliced off.  ``dia_spmv`` is the plain version of the banded kernel and
lives beside its CUDA wrapper in ``ops/spmv_banded.py``.  ``ell_spmv`` and
``dense_spmv`` are plain code in the JAX package too (no Pallas kernel):
the formats' own gather paths when they carry no banded or packed plan.
"""

from __future__ import annotations

import torch

from .registry import register
from .spmv_banded import dia_spmv_reference as dia_spmv  # noqa: F401


@register("coo_spmv", "reference")
def coo_spmv(row_idx, col_idx, values, b, num_rows):
    """y = A @ b for COO triplets (also the CSR classical path and the
    tail of the banded and packed layouts): an ``index_add_`` into an
    (n+1, k) buffer whose last row takes the padding entries."""
    gathered = b[col_idx] * values[:, None].to(b.dtype)
    out = torch.zeros((num_rows + 1, b.shape[1]), dtype=b.dtype,
                      device=b.device)
    out.index_add_(0, row_idx, gathered)
    return out[:num_rows]


@register("ell_spmv", "reference")
def ell_spmv(col_idx, values, b, valid_mask):
    """ELL: col_idx/values (n, width); y = sum_j vals[:, j] * b[cols[:, j]]
    over the valid slots."""
    gathered = b[col_idx]                            # (n, w, k)
    vals = torch.where(valid_mask, values, 0).to(b.dtype)
    return torch.einsum("nw,nwk->nk", vals, gathered)


@register("dense_spmv", "reference")
def dense_spmv(a, b):
    return torch.matmul(a, b)
