"""Batch module — thousands of small independent systems
(``ginkgo_tpu/batch.py`` in torch).

Analog of Ginkgo's batch type hierarchy: ``batch::MultiVector``
(``batch_multi_vector.hpp:52``), ``batch::matrix::{Csr,Dense,Ell,
Identity}``, ``batch::solver::{Bicgstab,Cg}`` and per-system stopping
(``batch_stop_enum.hpp``).  The formats share one sparsity pattern across
the batch (as Ginkgo's batch::matrix::Csr does) with per-entry values, in
the JAX package's stored layout.

The JAX package solves a batch as ``vmap`` of a whole Krylov solve.  Here
the lanes are folded into columns: a batch of ``nb`` systems with ``k``
right-hand sides each is one ``(n, nb·k)`` solve of the port's own
solvers, behind an operator that applies lane ``l``'s matrix to columns
``l·k .. l·k + k - 1``.  The solvers stop columns one by one, and the
``PerLane`` criterion makes the iteration loop keep its iteration count,
trip cap and audit rounds per lane, so each lane runs as if it were
solved alone.  Every product sums each row in a fixed order over the
shared ``(n, w)`` row layout (no atomics), so a solve gives the same bits
on every run.
"""

from __future__ import annotations

import numpy as np
import torch

from .base.dtypes import as_torch_dtype
from .base.exceptions import UnsupportedMatrixProperty
from .base.linop import LinOp
from .device import resolve_device
from .matrix.coo import pad_nnz
from .matrix.csr import Csr
from .matrix.dense import Dense
from .matrix.ell import Ell, row_positions
from .ops.gauss_jordan import batched_inverse
from .stop.criterion import Combined, Iteration, PerLane, ResidualNorm


def _batch_scalar(alpha, num_batch, like):
    """Normalize a scalar / (nb,) array / BatchMultiVector of shape
    (nb, 1, 1) to a (nb,) tensor on ``like``'s device (the per-entry
    scalars Ginkgo's batch add_scaled_identity takes as MultiVectors)."""
    if isinstance(alpha, BatchMultiVector):
        alpha = alpha.data
    alpha = torch.as_tensor(alpha, device=like.device)
    return torch.broadcast_to(alpha.reshape(-1) if alpha.ndim else alpha,
                              (num_batch,))


def _shared_pattern(items):
    """The canonical data of ``items``; raises unless they share one
    sparsity pattern."""
    ds = [it.canonical() for it in items]
    d = ds[0]
    for o in ds[1:]:
        if (o.shape != d.shape or o.nnz != d.nnz
                or not np.array_equal(o.row_idx, d.row_idx)
                or not np.array_equal(o.col_idx, d.col_idx)):
            raise ValueError("batch entries must share one sparsity pattern")
    return ds


def _upload_values(values: np.ndarray, dtype, device):
    vdtype = as_torch_dtype(values.dtype if dtype is None else dtype)
    return torch.from_numpy(np.ascontiguousarray(values)).to(
        device=device, dtype=vdtype)


def _ell_lanes_op(cols, vals):
    """The lanes' product over a shared row layout: ``cols`` (n, w) column
    of each slot, ``vals`` (n, w, nb) its value in each lane (0 in padded
    slots); the op maps ``x3`` (m, nb, k) -> (n, nb, k), each row summed
    over its ``w`` slots by one reduction, with no atomics."""
    return lambda x3: (vals[..., None] * x3.to(vals.dtype)[cols]).sum(dim=1)


# ---------------------------------------------------------------------------
# Batch formats (shared pattern, per-entry values)
# ---------------------------------------------------------------------------

class BatchCsr(LinOp):
    """batch::matrix::Csr — one sparsity, (num_batch, nnz_stored) values;
    the entries padded to ``pad_nnz`` with row ``n``, col 0, value 0."""

    def __init__(self, row_idx, col_idx, row_ptr, values, shape, nnz):
        self.row_idx = row_idx      # (nnz_stored,)
        self.col_idx = col_idx      # (nnz_stored,)
        self.row_ptr = row_ptr      # (n + 1,)
        self.values = values        # (num_batch, nnz_stored)
        self.shape = tuple(shape)   # (n, m) per entry
        self.nnz = int(nnz)

    @property
    def num_batch_items(self):
        return self.values.shape[0]

    def item(self, values_row) -> Csr:
        """One lane's matrix (pattern-consistent row_ptr, so row_lengths
        and friends are right on batch items)."""
        return Csr(row_ptr=self.row_ptr, col_idx=self.col_idx,
                   values=values_row, row_idx=self.row_idx,
                   shape=self.shape, nnz=self.nnz, strategy="classical")

    def lanes_op(self):
        """The product of every lane at once on an (m, nb, k) fold, over
        the entries laid out in their rows' slots (rows are contiguous and
        sorted, so slot j of row i is entry ``row_ptr[i] + j``; padded
        slots hold col 0 and value 0)."""
        n = self.shape[0]
        ptr = self.row_ptr.long()
        lengths = ptr[1:] - ptr[:-1]
        w = max(int(lengths.max()) if n else 0, 1)
        slot = torch.arange(w, device=ptr.device)
        live = slot[None, :] < lengths[:, None]
        pos = torch.where(live, ptr[:-1, None] + slot[None, :], 0)
        cols = torch.where(live, self.col_idx.long()[pos], 0)
        vals = torch.where(live[..., None], self.values.T[pos], 0)
        return _ell_lanes_op(cols, vals)

    def apply(self, b):
        """b: (num_batch, m, k) -> (num_batch, n, k)."""
        return self.lanes_op()(b.permute(1, 0, 2)).permute(1, 0, 2)

    def coo_lanes(self):
        """(rows, cols, values (nb, slots)) with padding rows at n."""
        return self.row_idx.long(), self.col_idx.long(), self.values

    @classmethod
    def from_data(cls, items, dtype=None, index_dtype=torch.int32,
                  pad_multiple: int = 8, device=None):
        """items: list of MatrixData sharing one pattern (values may differ),
        or (pattern MatrixData, values (nb, nnz)).  The tensors go to
        ``device`` (``None``: the CUDA device)."""
        device = resolve_device(device)
        if isinstance(items, tuple) and len(items) == 2:
            pattern, values = items
            d = pattern.canonical()
            values = np.asarray(values)
        else:
            ds = _shared_pattern(items)
            d = ds[0]
            values = np.stack([o.values for o in ds])
        nb, nnz = values.shape
        cap = pad_nnz(nnz, pad_multiple)
        rows = np.full(cap, d.shape[0], np.int64)
        cols = np.zeros(cap, np.int64)
        vals = np.zeros((nb, cap), values.dtype)
        rows[:nnz] = d.row_idx
        cols[:nnz] = d.col_idx
        vals[:, :nnz] = values

        def idx(a):
            return torch.from_numpy(a).to(device=device, dtype=index_dtype)

        return cls(row_idx=idx(rows), col_idx=idx(cols),
                   row_ptr=idx(d.row_ptrs().astype(np.int64)),
                   values=_upload_values(vals, dtype, device),
                   shape=d.shape, nnz=nnz)

    def to_dense_batch(self):
        n, m = self.shape
        out = torch.zeros((self.num_batch_items, n + 1, m),
                          dtype=self.values.dtype, device=self.values.device)
        out[:, self.row_idx.long(), self.col_idx.long()] = self.values
        return out[:, :n]

    def extract_diagonals(self):
        """(num_batch, n) diagonal values — batch Jacobi input."""
        on = (self.row_idx == self.col_idx) & (self.row_idx < self.shape[0])
        out = torch.zeros((self.num_batch_items, self.shape[0]),
                          dtype=self.values.dtype, device=self.values.device)
        out[:, self.row_idx[on].long()] = self.values[:, on]
        return out

    def add_scaled_identity(self, alpha, beta):
        """Per-entry ``beta_i*A_i + alpha_i*I`` (``batch_csr.hpp:380``).
        alpha/beta: scalars or (num_batch,) arrays.  Requires every diagonal
        entry structurally present, like the reference."""
        rows = self.row_idx[:self.nnz].cpu().numpy()
        cols = self.col_idx[:self.nnz].cpu().numpy()
        if np.count_nonzero(rows == cols) < min(self.shape):
            raise UnsupportedMatrixProperty(
                "add_scaled_identity: matrix has structurally zero "
                "diagonal entries")
        a = _batch_scalar(alpha, self.num_batch_items, self.values)[:, None]
        b = _batch_scalar(beta, self.num_batch_items, self.values)[:, None]
        on = (self.row_idx == self.col_idx).to(self.values.dtype)
        return BatchCsr(self.row_idx, self.col_idx, self.row_ptr,
                        b * self.values + a * on, self.shape, self.nnz)


class BatchDense(LinOp):
    """batch::matrix::Dense — (num_batch, n, m).  An array that is not a
    tensor goes to ``device`` (``None``: the CUDA device)."""

    def __init__(self, data, device=None):
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data),
                                   device=resolve_device(device))
        self.data = data

    @property
    def shape(self):
        return tuple(self.data.shape[1:])

    @property
    def num_batch_items(self):
        return self.data.shape[0]

    def item(self, data):
        return Dense(data=data)

    @property
    def values(self):
        return self.data

    def apply(self, b):
        return torch.bmm(self.data, b.to(self.data.dtype))

    def lanes_op(self):
        return lambda x3: self.apply(x3.permute(1, 0, 2)).permute(1, 0, 2)

    def extract_diagonals(self):
        return torch.diagonal(self.data, dim1=1, dim2=2)

    def add_scaled_identity(self, alpha, beta):
        """Per-entry ``beta_i*A_i + alpha_i*I`` (``batch_dense.hpp:384``)."""
        a = _batch_scalar(alpha, self.num_batch_items, self.data)[:, None,
                                                                  None]
        b = _batch_scalar(beta, self.num_batch_items, self.data)[:, None,
                                                                 None]
        eye = torch.eye(*self.shape, dtype=self.data.dtype,
                        device=self.data.device)
        return BatchDense(data=b * self.data + a * eye)


class BatchEll(LinOp):
    """batch::matrix::Ell — shared (n, w) cols, (num_batch, n, w) values;
    padded slots hold col 0 and value 0, as ``Ell``'s."""

    def __init__(self, col_idx, values, row_lengths, shape, nnz):
        self.col_idx = col_idx
        self.values = values
        self.row_lengths = row_lengths
        self.shape = tuple(shape)
        self.nnz = int(nnz)

    @property
    def num_batch_items(self):
        return self.values.shape[0]

    def item(self, v) -> Ell:
        return Ell(col_idx=self.col_idx, values=v,
                   row_lengths=self.row_lengths, shape=self.shape,
                   nnz=self.nnz)

    def lanes_op(self):
        return _ell_lanes_op(self.col_idx.long(),
                             self.values.permute(1, 2, 0).contiguous())

    def apply(self, b):
        return self.lanes_op()(b.permute(1, 0, 2)).permute(1, 0, 2)

    def _valid(self):
        return (torch.arange(self.col_idx.shape[1],
                             device=self.col_idx.device)[None, :]
                < self.row_lengths[:, None])

    def coo_lanes(self):
        """(rows, cols, values (nb, slots)) of the slots, padded slots at
        row n."""
        n, w = self.col_idx.shape
        rows = torch.arange(n, device=self.col_idx.device)[:, None].expand(
            n, w)
        rows = torch.where(self._valid(), rows, n)
        return (rows.reshape(-1), self.col_idx.long().reshape(-1),
                self.values.reshape(self.num_batch_items, -1))

    def extract_diagonals(self):
        on = self.col_idx == torch.arange(self.shape[0],
                                          device=self.col_idx.device)[:, None]
        return torch.where(on, self.values, 0).sum(dim=2)

    def add_scaled_identity(self, alpha, beta):
        """Per-entry ``beta_i*A_i + alpha_i*I`` (``batch_ell.hpp:392``).
        Requires every diagonal entry structurally present (each row must
        reference its own column with a stored slot)."""
        on = self.col_idx == torch.arange(self.shape[0],
                                          device=self.col_idx.device)[:, None]
        # padded slots carry col_idx == 0 (ell.py layout), so row 0's pads
        # would false-match its diagonal; only slots inside row_lengths are
        # structural entries
        on = on & self._valid()
        if int(on.any(dim=1).count_nonzero()) < min(self.shape):
            raise UnsupportedMatrixProperty(
                "add_scaled_identity: matrix has structurally zero "
                "diagonal entries")
        a = _batch_scalar(alpha, self.num_batch_items, self.values)[:, None,
                                                                    None]
        b = _batch_scalar(beta, self.num_batch_items, self.values)[:, None,
                                                                   None]
        add = on.to(self.values.dtype)[None, :, :]
        return BatchEll(self.col_idx, b * self.values + a * add,
                        self.row_lengths, self.shape, self.nnz)

    @classmethod
    def from_data(cls, items, dtype=None, index_dtype=torch.int32,
                  device=None):
        """items: MatrixData sharing one pattern; the common width is the
        pattern's longest row, as ``Ell.from_data`` plans each item."""
        device = resolve_device(device)
        ds = _shared_pattern(items)
        d = ds[0]
        n, m = d.shape
        row_ptr = d.row_ptrs()
        lengths = np.diff(row_ptr)
        w = max(int(lengths.max()) if d.nnz else 1, 1)
        pos = row_positions(row_ptr)
        cols = np.zeros((n, w), np.int64)
        cols[d.row_idx, pos] = d.col_idx
        values = np.stack([o.values for o in ds])
        vals = np.zeros((len(ds), n, w), values.dtype)
        vals[:, d.row_idx, pos] = values

        def idx(a):
            return torch.from_numpy(a).to(device=device, dtype=index_dtype)

        return cls(col_idx=idx(cols),
                   values=_upload_values(vals, dtype, device),
                   row_lengths=idx(lengths.astype(np.int64)), shape=(n, m),
                   nnz=d.nnz)


class BatchIdentity(LinOp):
    def __init__(self, size: int, num_batch: int = 1):
        self.size = int(size)
        self.num_batch = int(num_batch)

    @property
    def shape(self):
        return (self.size, self.size)

    def apply(self, b):
        return b


class BatchMultiVector:
    """batch::MultiVector (``batch_multi_vector.hpp:52``): (nb, n, k) with
    per-entry BLAS reductions — a thin named view over the raw tensor
    (which is itself accepted everywhere)."""

    def __init__(self, data):
        self.data = data   # (num_batch, n, k)

    @property
    def num_batch_items(self):
        return self.data.shape[0]

    @property
    def shape(self):
        return tuple(self.data.shape[1:])

    def compute_dot(self, other):
        o = other.data if isinstance(other, BatchMultiVector) else other
        return torch.sum(self.data * o, dim=1)            # (nb, k)

    def compute_conj_dot(self, other):
        o = other.data if isinstance(other, BatchMultiVector) else other
        return torch.sum(torch.conj(self.data) * o, dim=1)

    def compute_norm2(self):
        return torch.sqrt(torch.real(torch.sum(
            torch.conj(self.data) * self.data, dim=1)))

    def scale(self, alpha):
        return BatchMultiVector(data=self.data * alpha)

    def add_scaled(self, alpha, other):
        o = other.data if isinstance(other, BatchMultiVector) else other
        return BatchMultiVector(data=self.data + alpha * o)


# ---------------------------------------------------------------------------
# Batch preconditioners
# ---------------------------------------------------------------------------

class _GeneratedBatchPrecond:
    """Per-lane preconditioner: ``arrays`` holds every lane's data along
    axis 0 (the inverse diagonals (nb, n) or inverse blocks (nb, nblk, bs,
    bs)); ``lanes_op()`` applies all lanes at once to an (n, nb, k) fold,
    as the formats' does."""

    def __init__(self, arrays, op):
        self.arrays = arrays
        self._op = op

    def lanes_op(self):
        return self._op


def _diag_blocks(A_batch, nblk: int, bs: int):
    """(nb, nblk, bs, bs) diagonal blocks of every lane, unit-padded past n
    and on all-zero block rows (``jacobi._extract_diag_blocks`` for a
    batch)."""
    n = A_batch.shape[0]
    nb = A_batch.num_batch_items
    dtype, dev = A_batch.values.dtype, A_batch.values.device
    if isinstance(A_batch, BatchDense):
        pad = nblk * bs - n
        dense = torch.nn.functional.pad(A_batch.data, (0, pad, 0, pad))
        out = torch.diagonal(dense.reshape(nb, nblk, bs, nblk, bs),
                             dim1=1, dim2=3).permute(0, 3, 1, 2)
    else:
        rows, cols, vals = A_batch.coo_lanes()
        block_of = rows // bs
        keep = (cols // bs == block_of) & (rows < n)
        base = block_of[keep] * bs
        out = torch.zeros((nb, nblk, bs, bs), dtype=dtype, device=dev)
        # canonical entries: each block slot is written at most once
        out[:, block_of[keep], rows[keep] - base, cols[keep] - base] = \
            vals[:, keep]
    idx = torch.arange(bs, device=dev)
    pad_rows = (torch.arange(nblk, device=dev)[:, None] * bs
                + idx[None, :]) >= n
    zero_rows = (out == 0).all(dim=3)
    eye = torch.eye(bs, dtype=dtype, device=dev)
    return torch.where((pad_rows | zero_rows)[..., None], eye, out)


def _block_lanes_op(inv, n, bs):
    """x3 (n, nb, k) -> each lane's block-diagonal inverse times its
    columns, as ``BlockJacobi._apply`` computes one lane's."""
    nb, nblk = inv.shape[:2]

    def apply(x3):
        k, x_dtype = x3.shape[2], x3.dtype
        x3 = x3.to(inv.dtype)
        pad = nblk * bs - n
        if pad:
            x3 = torch.cat([x3, x3.new_zeros((pad, nb, k))], dim=0)
        seg = x3.reshape(nblk, bs, nb, k).permute(2, 0, 1, 3)
        out = torch.matmul(inv, seg)                 # (nb, nblk, bs, k)
        return out.permute(1, 2, 0, 3).reshape(nblk * bs, nb, k)[:n].to(
            x_dtype)

    return apply


class BatchJacobi:
    """Scalar/block Jacobi per batch entry (``batch_jacobi.hpp``)."""

    def __init__(self, max_block_size: int = 1):
        self.max_block_size = int(max_block_size)

    def generate(self, A_batch) -> _GeneratedBatchPrecond:
        if self.max_block_size <= 1:
            d = A_batch.extract_diagonals()
            inv = torch.where(d == 0, torch.ones_like(d), 1.0 / d)
            inv_t = inv.T.contiguous()
            return _GeneratedBatchPrecond(
                inv, lambda x3: inv_t[..., None].to(x3.dtype) * x3)
        n = A_batch.shape[0]
        bs = self.max_block_size
        nblk = -(-n // bs)
        nb = A_batch.num_batch_items
        blocks = _diag_blocks(A_batch, nblk, bs)
        inv_blocks = batched_inverse(blocks.reshape(nb * nblk, bs, bs)
                                     ).reshape(nb, nblk, bs, bs)
        return _GeneratedBatchPrecond(inv_blocks,
                                      _block_lanes_op(inv_blocks, n, bs))


# ---------------------------------------------------------------------------
# Batch solvers (the lanes folded into the columns of one solve)
# ---------------------------------------------------------------------------

class _LaneFold(LinOp):
    """``nb`` operators side by side on an (n, nb·k) multivector: lane l
    acts on columns l·k .. l·k + k - 1 through ``lanes_op`` on the
    (n, nb, k) view (laid out once, for the whole solve)."""

    def __init__(self, A_batch, lanes_op):
        self.shape = tuple(A_batch.shape)
        self.nb = A_batch.num_batch_items
        self.holder = A_batch         # the tensors behind it (dtype/device)
        self._lanes_op = lanes_op

    def _apply(self, b):
        n, kk = b.shape
        out = self._lanes_op(b.reshape(n, self.nb, kk // self.nb))
        return out.reshape(self.shape[0], kk)


def _batch_criteria(dtype, max_iterations, tolerance, tol_type):
    baseline = "rhs_norm" if tol_type == "relative" else "absolute"
    return Combined(criteria=(
        Iteration(max_iters=max_iterations),
        ResidualNorm(reduction_factor=tolerance, baseline=baseline)))


class _BatchSolver:
    def __init__(self, solve_fn, *, max_iterations=100, tolerance=1e-8,
                 tolerance_type="relative", preconditioner=None):
        self._solve = solve_fn
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.tolerance_type = tolerance_type
        self.preconditioner = preconditioner

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A_batch):
        return _GeneratedBatchSolver(self, A_batch)

    def solve(self, A_batch, b, x0=None):
        """b: (num_batch, n) or (num_batch, n, k), moved to A_batch's
        device.  Returns a SolveResult with x of b's shape, iterations,
        resnorm and converged of shape (num_batch, k), or (num_batch,) for
        a 2-D b, and stagnated of shape (num_batch, k)."""
        from .log import logger as _log
        from .solver.common import SolveResult
        dev = A_batch.values.device
        b = torch.as_tensor(b, device=dev)
        squeeze = b.ndim == 2
        if squeeze:
            b = b[..., None]
        nb, n, k = b.shape
        crit = PerLane(_batch_criteria(b.dtype, self.max_iterations,
                                       self.tolerance, self.tolerance_type),
                       width=k)
        M = None
        if self.preconditioner is not None:
            M = _LaneFold(A_batch,
                          self.preconditioner.generate(A_batch).lanes_op())

        def fold(v):
            return v.permute(1, 0, 2).reshape(n, nb * k)

        x0f = None if x0 is None else fold(
            torch.as_tensor(x0, device=dev).reshape(nb, n, k))
        # the folded solve's own events belong to this batch solve
        with _log.silenced():
            res = self._solve(_LaneFold(A_batch, A_batch.lanes_op()),
                              fold(b), x0f, criteria=crit, preconditioner=M)

        def lanes(v):
            v = v.reshape(nb, k)
            return v[:, 0] if squeeze else v

        x = res.x.reshape(n, nb, k).permute(1, 0, 2)
        # stagnated keeps its k axis, as the reference's does
        res = SolveResult(x=x[..., 0] if squeeze else x,
                          iterations=lanes(res.iterations),
                          resnorm=lanes(res.resnorm),
                          converged=lanes(res.converged),
                          stagnated=res.stagnated.reshape(nb, k))
        if _log.has_loggers():
            _log.dispatch(_log.BATCH_SOLVE_COMPLETED, num_systems=nb,
                          result=res)
        return res


class _GeneratedBatchSolver:
    def __init__(self, factory, A_batch):
        self.factory = factory
        self.A_batch = A_batch

    def solve(self, b, x0=None):
        return self.factory.solve(self.A_batch, b, x0)

    def apply(self, b):
        return self.factory.solve(self.A_batch, b).x


def BatchBicgstab(**kw) -> _BatchSolver:
    """batch::solver::Bicgstab (``batch_bicgstab.hpp:50``)."""
    from .solver import bicgstab
    return _BatchSolver(bicgstab.solve, **kw)


def BatchCg(**kw) -> _BatchSolver:
    """batch::solver::Cg (``batch_cg.hpp``)."""
    from .solver import cg
    return _BatchSolver(cg.solve, **kw)
