"""Fbcsr — fixed-size block CSR (``ginkgo_tpu/matrix/fbcsr.py`` in torch).

Analog of ``include/ginkgo/core/matrix/fbcsr.hpp:99``: the matrix is tiled
into bs x bs dense blocks; only nonzero blocks are stored.  Without a
banded or packed plan (``fast=False``, or neither layout economical) the
SpMV is a gather of b-blocks, one batched (nnzb, bs, bs) x (nnzb, bs, k)
product (``torch.einsum``; bf16/f16 accumulate in f32) and an
``index_add_`` over the block rows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base.linop import LinOp
from ..base.matrix_data import MatrixData
from ..device import resolve_device


class Fbcsr(LinOp):
    def __init__(self, block_rows, block_cols, blocks, shape, block_size,
                 nnzb, fast_op=None):
        self.block_rows = block_rows    # (cap,) block-row index, pad nbr
        self.block_cols = block_cols    # (cap,) block-col index, pad 0
        self.blocks = blocks            # (cap, bs, bs) dense blocks
        self.shape = tuple(shape)
        self.block_size = int(block_size)
        self.nnzb = int(nnzb)
        self.fast_op = fast_op          # SpmvPlan fast path

    def _apply(self, b):
        if self.fast_op is not None:
            return self.fast_op._apply(b)
        from .dense import _acc_dtype
        n, m = self.shape
        bs = self.block_size
        nbr = -(-n // bs)
        nbc = -(-m // bs)
        k = b.shape[1]
        pad_m = nbc * bs - m
        bp = F.pad(b, (0, 0, 0, pad_m)) if pad_m else b
        b_blocks = bp.reshape(nbc, bs, k)
        gathered = b_blocks[self.block_cols.long()]        # (cap, bs, k)
        acc = _acc_dtype(b.dtype)
        prod = torch.einsum("bij,bjk->bik",
                            self.blocks.to(b.dtype).to(acc),
                            gathered.to(acc)).to(b.dtype)
        out = torch.zeros((nbr + 1, bs, k), dtype=b.dtype, device=b.device)
        out.index_add_(0, self.block_rows.long(), prod)
        return out[:nbr].reshape(nbr * bs, k)[:n]

    @classmethod
    def from_data(cls, data: MatrixData, block_size: int = 4, dtype=None,
                  index_dtype=torch.int32, pad_multiple: int = 8,
                  fast: bool = True, device=None):
        from .csr import _upload, host_value_types
        device = resolve_device(device)
        d = data.canonical()
        n, m = d.shape
        bs = int(block_size)
        br = d.row_idx // bs
        bc = d.col_idx // bs
        keys = br.astype(np.int64) * (-(-m // bs)) + bc
        uniq, inv = np.unique(keys, return_inverse=True)
        nnzb = uniq.shape[0]
        cap = max(pad_multiple, -(-max(nnzb, 1) // pad_multiple)
                  * pad_multiple)
        vdtype, host = host_value_types(d.values.dtype, dtype)
        blocks = np.zeros((cap, bs, bs), host)
        li = d.row_idx - br * bs
        lj = d.col_idx - bc * bs
        # canonical data holds each coordinate once, so a plain indexed
        # assignment places every entry (np.add.at is needed only for
        # duplicates, and is very slow at 10^8 entries)
        blocks[inv, li, lj] = d.values.astype(host)
        rows = np.full(cap, -(-n // bs), np.int64)
        cols = np.zeros(cap, np.int64)
        rows[:nnzb] = uniq // (-(-m // bs))
        cols[:nnzb] = uniq % (-(-m // bs))
        fast_op = None
        if fast and d.nnz:
            from .fastpath import plan_fast_spmv
            fast_op = plan_fast_spmv(d, dtype, index_dtype, device=device)
        return cls(block_rows=_upload(rows, device, index_dtype),
                   block_cols=_upload(cols, device, index_dtype),
                   blocks=_upload(blocks, device, vdtype), shape=(n, m),
                   block_size=bs, nnzb=nnzb, fast_op=fast_op)

    def to_dense(self):
        n, m = self.shape
        bs = self.block_size
        nbr, nbc = -(-n // bs), -(-m // bs)
        dense = torch.zeros((nbr + 1, nbc, bs, bs), dtype=self.blocks.dtype,
                            device=self.blocks.device)
        dense.index_put_((self.block_rows.long(), self.block_cols.long()),
                         self.blocks, accumulate=True)
        return dense[:nbr].permute(0, 2, 1, 3).reshape(
            nbr * bs, nbc * bs)[:n, :m]

    def compute_absolute(self):
        """|A| entrywise (AbsoluteComputable; abs over the value tensors)."""
        from ..base.linop import absolute_of_storage
        return absolute_of_storage(self)

    def to_matrix_data(self) -> MatrixData:
        from .csr import _values_numpy
        bs = self.block_size
        rows = self.block_rows[:self.nnzb].cpu().numpy()
        cols = self.block_cols[:self.nnzb].cpu().numpy()
        blocks = _values_numpy(self.blocks[:self.nnzb])
        li, lj = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
        r = (rows[:, None, None] * bs + li[None]).ravel()
        c = (cols[:, None, None] * bs + lj[None]).ravel()
        v = blocks.ravel()
        keep = (v != 0) & (r < self.shape[0]) & (c < self.shape[1])
        return MatrixData(self.shape, r[keep], c[keep],
                          v[keep]).sort_row_major()

    def to_csr(self, **kwargs):
        from .csr import Csr
        kwargs.setdefault("device", self.blocks.device)
        return Csr.from_data(self.to_matrix_data(), **kwargs)
