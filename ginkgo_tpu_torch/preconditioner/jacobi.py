"""(Block-)Jacobi preconditioner (``ginkgo_tpu/preconditioner/jacobi.py`` in
torch).

Analog of ``include/ginkgo/core/preconditioner/jacobi.hpp:187`` /
``core/preconditioner/jacobi.cpp:328-412``:

* ``max_block_size == 1``: scalar Jacobi — invert the diagonal, optionally
  after L1 row-sum augmentation (``scalar_l1``, jacobi.cpp:340-344).
* ``max_block_size > 1``: block Jacobi — uniform block partition (or user
  ``block_pointers``, or the ``natural_blocks`` found in the pattern), each
  diagonal block gathered into a dense (num_blocks, bs, bs) batch on A's
  device and inverted by ``ops/gauss_jordan.batched_inverse``; the apply is
  a batched small-matrix product (``torch.matmul``).  Ginkgo's
  ``precision_reduction`` adaptive storage maps to a ``storage_dtype`` for
  the inverted blocks (or, with ``storage_optimization="auto"``, a
  per-block choice by the cond·eps rule) with arithmetic kept in the value
  type.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.dtypes import as_torch_dtype, eps, reduce_precision
from ..base.linop import LinOp
from ..matrix.diagonal import Diagonal
from ..ops.gauss_jordan import batched_inverse


def _block_product(inv, seg, arith):
    """(nb, bs, bs) inverses times (nb, bs, k) segments, in ``arith``."""
    return torch.matmul(inv.to(arith), seg.to(arith))


def _segments(b, nb, bs):
    """(n, k) -> (nb, bs, k), zero-padded past n."""
    pad = nb * bs - b.shape[0]
    if pad:
        b = torch.cat([b, b.new_zeros((pad, b.shape[1]))], dim=0)
    return b.reshape(nb, bs, -1)


class BlockJacobi(LinOp):
    """Generated block-Jacobi operator: x = blockdiag(inv(D_b)) @ b."""

    def __init__(self, inv_blocks, shape, block_size, arith_dtype):
        self.inv_blocks = inv_blocks    # (num_blocks, bs, bs), storage dtype
        self.shape = tuple(shape)
        self.block_size = block_size
        self.arith_dtype = arith_dtype

    def _apply(self, b):
        n, nb = self.shape[0], self.inv_blocks.shape[0]
        out = _block_product(self.inv_blocks,
                             _segments(b, nb, self.block_size),
                             self.arith_dtype)
        return out.reshape(nb * self.block_size, -1)[:n].to(b.dtype)


class AdaptiveBlockJacobi(LinOp):
    """Per-block adaptive precision storage (``precision_reduction``
    autodetection, jacobi.hpp:311-403): well-conditioned blocks live in a
    reduced-precision buffer, ill-conditioned ones at full precision; the
    apply runs both groups and sums (each block belongs to exactly one).
    Arithmetic is always the value type."""

    def __init__(self, inv_full, inv_reduced, shape, block_size,
                 arith_dtype):
        self.inv_full = inv_full        # (nb, bs, bs), 0 where reduced
        self.inv_reduced = inv_reduced  # (nb, bs, bs) reduced, 0 where full
        self.shape = tuple(shape)
        self.block_size = block_size
        self.arith_dtype = arith_dtype

    def _apply(self, b):
        n, nb = self.shape[0], self.inv_full.shape[0]
        seg = _segments(b, nb, self.block_size)
        out = _block_product(self.inv_full, seg, self.arith_dtype) \
            + _block_product(self.inv_reduced, seg, self.arith_dtype)
        return out.reshape(nb * self.block_size, -1)[:n].to(b.dtype)

    @property
    def storage_fraction_reduced(self):
        """Diagnostic: fraction of blocks stored reduced."""
        nz = (self.inv_reduced != 0).any(dim=2).any(dim=1)
        return nz.to(torch.float32).mean()


class VariableBlockJacobi(LinOp):
    """Block-Jacobi with per-block sizes (Ginkgo's ``block_pointers`` /
    natural-block layout): rows gathered per block, padded to bs_max,
    batched product, scattered back."""

    def __init__(self, inv_blocks, rows_pad, shape, arith_dtype):
        self.inv_blocks = inv_blocks    # (nb, bs_max, bs_max)
        self.rows_pad = rows_pad        # (nb, bs_max) global row, pad n
        self.shape = tuple(shape)
        self.arith_dtype = arith_dtype

    def _apply(self, b):
        n = self.shape[0]
        rows = self.rows_pad.long()
        valid = (rows < n)[:, :, None]
        seg = b[rows.clamp(0, n - 1)]                    # (nb, bs_max, k)
        seg = torch.where(valid, seg, torch.zeros((), dtype=seg.dtype,
                                                  device=seg.device))
        out = _block_product(self.inv_blocks, seg, self.arith_dtype)
        flat = out.new_zeros((n + 1, b.shape[1]))
        flat[torch.where(rows < n, rows, n).reshape(-1)] = \
            out.reshape(-1, b.shape[1])
        return flat[:n].to(b.dtype)


class Jacobi:
    """Factory: ``Jacobi(max_block_size=8).generate(A)``."""

    def __init__(self, max_block_size: int = 1, *, scalar_l1: bool = False,
                 storage_dtype=None, block_pointers=None,
                 natural_blocks: bool = False,
                 storage_optimization: str = None,
                 accuracy: float = 1e-2):
        self.max_block_size = max_block_size
        self.scalar_l1 = scalar_l1
        self.storage_dtype = storage_dtype
        self.block_pointers = block_pointers
        self.natural_blocks = natural_blocks
        # 'auto': per-block adaptive precision — block stored reduced when
        # cond(B) * eps(reduced) < accuracy (jacobi_utils.hpp heuristic)
        self.storage_optimization = storage_optimization
        self.accuracy = accuracy

    # keep Ginkgo's fluent spelling available
    @classmethod
    def build(cls, **kwargs):
        return cls(**kwargs)

    def generate(self, A) -> LinOp:
        n = A.shape[0]
        if self.block_pointers is not None:
            return self._generate_variable(
                A, np.asarray(self.block_pointers, np.int64))
        if self.max_block_size <= 1:
            diag = A.extract_diagonal().values
            if self.scalar_l1:
                # add off-diagonal row L1 mass to the diagonal
                row_abs = _row_abs_sum(A)
                diag = diag + (row_abs - torch.abs(diag))
            inv = torch.where(diag == 0, torch.ones_like(diag), 1.0 / diag)
            if self.storage_dtype is not None:
                inv = inv.to(as_torch_dtype(self.storage_dtype)).to(
                    diag.dtype)
            return Diagonal(inv)

        bs = int(self.max_block_size)
        if self.natural_blocks:
            return self._generate_variable(A, find_natural_blocks(A, bs))
        nb = -(-n // bs)
        dense_blocks = _extract_diag_blocks(A, nb, bs)
        inv_blocks = batched_inverse(dense_blocks)
        if self.storage_optimization == "auto":
            reduced = as_torch_dtype(self.storage_dtype
                                     or reduce_precision(dense_blocks.dtype))
            # cond estimate via 1-norms of B and B^-1
            bn = dense_blocks.abs().sum(dim=1).amax(dim=1)
            bin_ = inv_blocks.abs().sum(dim=1).amax(dim=1)
            use_reduced = (bn * bin_ * eps(reduced)
                           < self.accuracy)[:, None, None]
            zero = torch.zeros((), dtype=inv_blocks.dtype,
                               device=inv_blocks.device)
            return AdaptiveBlockJacobi(
                inv_full=torch.where(use_reduced, zero, inv_blocks),
                inv_reduced=torch.where(use_reduced, inv_blocks,
                                        zero).to(reduced),
                shape=A.shape, block_size=bs,
                arith_dtype=dense_blocks.dtype)
        storage = as_torch_dtype(self.storage_dtype or dense_blocks.dtype)
        return BlockJacobi(inv_blocks=inv_blocks.to(storage), shape=A.shape,
                           block_size=bs, arith_dtype=dense_blocks.dtype)

    def _generate_variable(self, A, ptrs: np.ndarray):
        """Blocks from explicit pointers: [ptrs[i], ptrs[i+1]) rows each."""
        n = A.shape[0]
        if ptrs[0] != 0 or ptrs[-1] != n or (np.diff(ptrs) <= 0).any():
            raise ValueError("block_pointers must cover [0, n) contiguously")
        sizes = np.diff(ptrs)
        nb = sizes.shape[0]
        bs_max = int(sizes.max())
        rows_pad = np.full((nb, bs_max), n, np.int64)
        bi_all = np.repeat(np.arange(nb), sizes)
        pos_all = np.arange(n) - np.repeat(ptrs[:-1], sizes)
        rows_pad[bi_all, pos_all] = np.arange(n)
        d = A.to_matrix_data().canonical()
        blocks = np.zeros((nb, bs_max, bs_max), d.values.dtype)
        # unit-pad the diagonal beyond each block's true size so the
        # padded systems stay invertible
        pb, pk = np.nonzero(np.arange(bs_max)[None, :] >= sizes[:, None])
        blocks[pb, pk, pk] = 1
        block_of = np.searchsorted(ptrs, d.row_idx, side="right") - 1
        in_blk = (d.col_idx >= ptrs[block_of]) & \
            (d.col_idx < ptrs[block_of + 1])
        bi = block_of[in_blk]
        li = d.row_idx[in_blk] - ptrs[bi]
        lj = d.col_idx[in_blk] - ptrs[bi]
        np.add.at(blocks, (bi, li, lj), d.values[in_blk])
        device = _device_of(A)
        inv = batched_inverse(torch.from_numpy(blocks).to(device))
        storage = as_torch_dtype(self.storage_dtype or inv.dtype)
        return VariableBlockJacobi(
            inv_blocks=inv.to(storage),
            rows_pad=torch.from_numpy(rows_pad.astype(np.int32)).to(device),
            shape=A.shape, arith_dtype=inv.dtype)


def _device_of(A):
    dev = getattr(A, "device", None)
    return dev if dev is not None else A.values.device


def find_natural_blocks(A, max_block_size: int) -> np.ndarray:
    """Detect natural diagonal blocks from the sparsity pattern
    (``find_blocks`` kernel analog, jacobi.cpp:320-326): consecutive rows
    join a block while they are mutually coupled (both (i, i+1) and
    (i+1, i) stored) and the block stays within ``max_block_size``."""
    n = A.shape[0]
    if not hasattr(A, "to_matrix_data"):
        return np.arange(n + 1)
    d = A.to_matrix_data().canonical()
    if n == 0:
        return np.zeros(1, np.int64)
    # link i <-> i+1 present when both (i, i+1) and (i+1, i) are stored
    sup = np.zeros(max(n - 1, 1), bool)
    sub = np.zeros(max(n - 1, 1), bool)
    m1 = d.col_idx == d.row_idx + 1
    sup[d.row_idx[m1]] = True
    m2 = d.row_idx == d.col_idx + 1
    sub[d.col_idx[m2]] = True
    coupled = sup & sub if n > 1 else np.zeros(0, bool)
    # greedy left-to-right chunking of each coupled chain into blocks of at
    # most max_block_size — a block starts at each chain start and every
    # max_block_size rows within a chain
    chain_start = np.ones(n, bool)
    chain_start[1:] = ~coupled
    chain_first = np.flatnonzero(chain_start)
    chain_id = np.cumsum(chain_start) - 1
    offset_in_chain = np.arange(n) - chain_first[chain_id]
    block_start = chain_start | (offset_in_chain % max_block_size == 0)
    return np.append(np.flatnonzero(block_start), n).astype(np.int64)


def _row_abs_sum(A):
    """Row sums of |A| over the stored entries of a Csr or Coo."""
    n = A.shape[0]
    out = torch.zeros(n + 1, dtype=torch.abs(A.values).dtype,
                      device=A.values.device)
    out.index_add_(0, A.row_idx, torch.abs(A.values))
    return out[:n]


def _extract_diag_blocks(A, nb: int, bs: int):
    """Gather the (nb, bs, bs) diagonal blocks on A's device; unit-pad rows
    past n so the padded trailing block stays invertible."""
    n = A.shape[0]
    if hasattr(A, "row_idx"):                        # Csr, Coo
        # only the entries inside their row's block (a few in nine on a
        # 27-point stencil) are scattered; padding slots have row n
        block_of = A.row_idx // bs
        keep = (A.col_idx // bs == block_of) & (A.row_idx < n)
        block_of = block_of[keep].long()
        base = block_of * bs
        out = torch.zeros((nb, bs, bs), dtype=A.values.dtype,
                          device=A.values.device)
        out.index_put_((block_of, A.row_idx[keep].long() - base,
                        A.col_idx[keep].long() - base), A.values[keep],
                       accumulate=True)
    else:
        dense = A.to_dense()
        pad = nb * bs - n
        dense = torch.nn.functional.pad(dense, (0, pad, 0, pad))
        out = torch.stack([dense[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs]
                           for i in range(nb)])
    # unit diagonal on padded rows AND on in-range all-zero rows (a zero
    # diagonal block row would otherwise poison the batched inverse with
    # nan/inf — the scalar path's diag==0 guard, blockwise)
    idx = torch.arange(bs, device=out.device)
    pad_rows = (torch.arange(nb, device=out.device)[:, None] * bs
                + idx[None, :]) >= n                  # (nb, bs)
    zero_rows = (out == 0).all(dim=2)                 # (nb, bs)
    eye = torch.eye(bs, dtype=out.dtype, device=out.device)
    return torch.where((pad_rows | zero_rows)[:, :, None], eye[None], out)
