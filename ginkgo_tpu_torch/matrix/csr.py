"""CSR format — the workhorse (``ginkgo_tpu/matrix/csr.py`` in torch).

Analog of ``include/ginkgo/core/matrix/csr.hpp:104``.  Ginkgo's SpMV
strategy objects become *build-time layout choices*: the constructor runs
the host planner (``_process_strategy``, verbatim from the JAX package, so
the planned arrays are identical) and uploads whatever auxiliary arrays the
chosen kernel needs.  The kernel registry picks the plain torch or CUDA
implementation from the device of the operands.

Strategies here:
  - ``classical``: gather + ``index_add_`` over an explicit row-index
    expansion (``coo_spmv``).
  - ``banded``: diagonal-offset layout for stencil-like matrices
    (``ops/spmv_banded.py``).
  - ``packed``: packed-slot windowed-ELL for unstructured matrices with
    column locality (``ops/spmv_packed.py``), applied through its compact
    sliced stream (``ops/spmv_sell.py``); off-layout entries spill to a
    COO tail.
  - ``automatical``: ``banded`` when the band census fits, else ``packed``
    when its padding stays economical, else ``classical``.

``transpose``/``conj_transpose``, ``to_dense``, the elementwise maps
(``scale``, ``inv_scale``, ``compute_absolute``, ``astype``) and a
classical ``add_scaled_identity`` run on the matrix's device; the format
conversions, permutations and submatrices go through ``MatrixData`` on
the host and plan again, as in the JAX package; so do ``spgemm`` and
``spgeam`` (``ops/spgemm.py``), whose product numeric may run on the
matrix's device.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..base.dtypes import as_torch_dtype
from ..base.linop import LinOp, map_tensors
from ..base.matrix_data import MatrixData
from ..device import resolve_device
from ..ops.registry import lookup
from ..ops.spmv_sell import sell_from_packed
from .coo import Coo, pad_nnz


def fast_spmv_apply(op, b):
    """Banded/packed + COO-tail SpMV dispatch over the aux attributes.
    Returns None when the operator carries no fast-path layout (caller
    falls back); raises for a packed operator without its layout."""
    if op.strategy == "banded" and op.diag_values is not None:
        y = lookup("dia_spmv", b.device)(op.diag_offsets, op.diag_values,
                                         dict(op.band_meta), b)
    elif op.strategy == "packed":
        if op.sell is None:
            raise ValueError("a packed Csr needs its planned slab (pell_meta,"
                             " pell_vals, pell_idx, pell_qw, pell_xbase)")
        y = lookup("pell_spmv", b.device)(op.sell, op.sell_meta, b)
    else:
        return None
    if op.tail_rows is not None:
        y = y + lookup("coo_spmv", b.device)(op.tail_rows, op.tail_cols,
                                             op.tail_vals, b, op.shape[0])
    return y


def set_packed(op, pell_meta, slab, device):
    """Give ``op`` (a ``Csr`` or an ``SpmvPlan``) its packed layout: the
    compact stream the kernel reads, built on ``device`` (``sell``,
    ``sell_meta``; None without a slab), and the slab itself on the host
    (``pell_vals (Gs, 8*Wv, 8, 128)``, ``pell_idx`` int16 of the same
    shape, ``pell_qw (Gs*8*Wv,)`` and ``pell_xbase (Gs,)`` int32)."""
    op.sell = op.sell_meta = None   # sv, sc, sp, xbase
    if slab[0] is not None:
        op.sell, op.sell_meta = sell_from_packed(
            *(t.to(device) for t in slab), pell_meta)
        slab = tuple(t.cpu() for t in slab)
    op.pell_meta = pell_meta
    op.pell_vals, op.pell_idx, op.pell_qw, op.pell_xbase = slab


def host_value_types(data_dtype, dtype=None):
    """(torch value type, numpy type the host plans in) for values of
    numpy type ``data_dtype`` stored as ``dtype`` (default: their own).
    bf16 is planned in f32 (numpy has no bf16) and rounded on upload."""
    vdtype = as_torch_dtype(data_dtype if dtype is None else dtype)
    host = (np.dtype(np.float32) if vdtype == torch.bfloat16
            else torch.empty(0, dtype=vdtype).numpy().dtype)
    return vdtype, host


def _upload(arr, device, dtype: torch.dtype):
    """numpy array -> tensor of ``dtype`` on ``device`` (converted on the
    host where numpy has the type, so only the final bytes cross)."""
    arr = np.asarray(arr)
    if dtype != torch.bfloat16:
        arr = arr.astype(torch.empty(0, dtype=dtype).numpy().dtype,
                         copy=False)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                          dtype=dtype)


def _scalar_on(alpha, t):
    """``alpha`` where it can meet ``t``: a tensor scalar moves to ``t``'s
    device (the packed slab stays on the host while ``alpha`` may live
    on the card); a Python number passes through."""
    return alpha.to(t.device) if isinstance(alpha, torch.Tensor) else alpha


def aux_device_kw(n, value_dtype, index_dtype, tail, pell, device):
    """Pad + device-place the COO tail produced by ``_process_strategy``,
    and hand over its packed layout as host tensors (``Csr`` builds the
    stream the SpMV reads on ``device``); ``value_dtype`` is the torch
    value type."""
    kw = {}
    if tail is not None:
        tr, tc, tv = tail
        tcap = pad_nnz(len(tr), 8)
        tro = np.full(tcap, n, np.int64)
        tco = np.zeros(tcap, np.int64)
        tvo = np.zeros(tcap, np.asarray(tv).dtype)
        tro[:len(tr)] = tr
        tco[:len(tr)] = tc
        tvo[:len(tr)] = tv
        kw.update(tail_rows=_upload(tro, device, index_dtype),
                  tail_cols=_upload(tco, device, index_dtype),
                  tail_vals=_upload(tvo, device, value_dtype))
    if pell is not None:
        kw.update(pell_meta=pell["meta"],
                  pell_vals=_upload(pell["vals"], "cpu", value_dtype),
                  pell_idx=_upload(pell["idx"], "cpu", torch.int16),
                  pell_qw=_upload(pell["qw"], "cpu", torch.int32),
                  pell_xbase=_upload(pell["xbase_row"], "cpu", torch.int32))
    return kw


class Csr(LinOp):
    """CSR matrix with the aux arrays of its SpMV strategy, all tensors on
    one device but the packed slab, which stays on the host."""

    def __init__(self, row_ptr, col_idx, values, row_idx, shape, nnz,
                 strategy="classical", diag_offsets=None, band_meta=None,
                 diag_values=None, tail_rows=None, tail_cols=None,
                 tail_vals=None, pell_meta=None, pell_vals=None,
                 pell_idx=None, pell_qw=None, pell_xbase=None):
        self.row_ptr = row_ptr      # (n+1,) int
        self.col_idx = col_idx      # (nnz_stored,) int
        self.values = values        # (nnz_stored,)
        self.row_idx = row_idx      # (nnz_stored,) int, expanded rows
        self.shape = tuple(shape)
        self.nnz = int(nnz)
        self.strategy = strategy
        # banded aux: static diagonal offsets + layout plan, plus the
        # (G, D, S, 128) blocked diagonal values
        self.diag_offsets = diag_offsets
        self.band_meta = band_meta
        self.diag_values = diag_values
        # off-layout outliers kept as a small COO correction
        self.tail_rows = tail_rows
        self.tail_cols = tail_cols
        self.tail_vals = tail_vals
        # packed-slot windowed-ELL aux: the planned slab, kept on the host
        # (no path reads it on the card), and its compact stream, built
        # here on the operator's device: the one array set the SpMV reads
        set_packed(self, pell_meta, (pell_vals, pell_idx, pell_qw,
                                     pell_xbase), values.device)

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    # -- SpMV ------------------------------------------------------------------
    def _apply(self, b):
        y = fast_spmv_apply(self, b)
        if y is not None:
            return y
        return lookup("coo_spmv", b.device)(self.row_idx, self.col_idx,
                                            self.values, b, self.shape[0])

    # -- construction ------------------------------------------------------------
    @classmethod
    def from_data(cls, data: MatrixData, dtype=None,
                  index_dtype=torch.int32, strategy: str = "automatical",
                  pad_multiple: int = 8, device=None):
        """Plan ``data`` on the host and place it on ``device`` (``None``:
        the CUDA device; raises when there is none)."""
        device = resolve_device(device)
        return cls._from_canonical_data(data.canonical(), dtype=dtype,
                                        index_dtype=index_dtype,
                                        strategy=strategy,
                                        pad_multiple=pad_multiple,
                                        device=device)

    @classmethod
    def _from_canonical_data(cls, d: MatrixData, dtype=None,
                             index_dtype=torch.int32,
                             strategy: str = "automatical",
                             pad_multiple: int = 8, device=None):
        """Build from already row-major-sorted, deduplicated data WITHOUT
        re-canonicalizing.  A bf16 ``dtype`` is planned in f32 (numpy has
        no bf16) and rounded when the arrays are uploaded."""
        device = resolve_device(device)
        n, m = d.shape
        nnz = d.nnz
        vdtype, host_dtype = host_value_types(d.values.dtype, dtype)
        values_np = d.values.astype(host_dtype, copy=False)

        (strategy, diag_offsets, band_meta, diag_values,
         tail, pell) = _process_strategy(strategy, d, values_np)

        cap = pad_nnz(nnz, pad_multiple)
        rows = np.full(cap, n, np.int64)
        cols = np.zeros(cap, np.int64)
        vals = np.zeros(cap, values_np.dtype)
        rows[:nnz] = d.row_idx
        cols[:nnz] = d.col_idx
        vals[:nnz] = values_np
        row_ptr = d.row_ptrs()
        aux_kw = aux_device_kw(n, vdtype, index_dtype, tail, pell, device)
        return cls(row_ptr=_upload(row_ptr, device, index_dtype),
                   col_idx=_upload(cols, device, index_dtype),
                   values=_upload(vals, device, vdtype),
                   row_idx=_upload(rows, device, index_dtype),
                   shape=(n, m), nnz=nnz, strategy=strategy,
                   diag_offsets=diag_offsets, band_meta=band_meta,
                   diag_values=None if diag_values is None
                   else _upload(diag_values, device, vdtype), **aux_kw)

    @classmethod
    def from_dense(cls, dense, **kwargs):
        if isinstance(dense, torch.Tensor):
            dense = _values_numpy(dense)
        return cls.from_data(MatrixData.from_dense(np.asarray(dense)),
                             **kwargs)

    # -- conversions ---------------------------------------------------------------
    def to_dense(self):
        return self.to_coo().to_dense()

    def to_coo(self):
        return Coo(row_idx=self.row_idx, col_idx=self.col_idx,
                   values=self.values, shape=self.shape, nnz=self.nnz)

    def to_matrix_data(self) -> MatrixData:
        k = self.nnz
        return MatrixData(self.shape, self.row_idx[:k].cpu().numpy(),
                          self.col_idx[:k].cpu().numpy(),
                          _values_numpy(self.values[:k]))

    def _rebuild_kw(self, kw):
        """A host rebuild lands on this matrix's device in its value type
        unless the caller says otherwise."""
        kw.setdefault("device", self.device)
        kw.setdefault("dtype", self.dtype)
        return kw

    def to_ell(self, **kw):
        from .ell import Ell
        return Ell.from_data(self.to_matrix_data(), **self._rebuild_kw(kw))

    def to_sellp(self, **kw):
        from .sellp import Sellp
        return Sellp.from_data(self.to_matrix_data(), **self._rebuild_kw(kw))

    def to_hybrid(self, **kw):
        from .hybrid import Hybrid
        return Hybrid.from_data(self.to_matrix_data(),
                                **self._rebuild_kw(kw))

    def to_fbcsr(self, **kw):
        from .fbcsr import Fbcsr
        return Fbcsr.from_data(self.to_matrix_data(), **self._rebuild_kw(kw))

    def to_sparsity_csr(self, **kw):
        from .sparsity_csr import SparsityCsr
        kw.setdefault("device", self.device)
        return SparsityCsr.from_data(self.to_matrix_data(), **kw)

    def extract_diagonal(self):
        return self.to_coo().extract_diagonal()

    # -- transposes ----------------------------------------------------------------
    def transpose(self):
        """Transpose on the matrix's device: a banded matrix stays banded
        (its diagonals shifted, as the JAX package's ``_banded_transposed``
        does), any other comes back ``classical``."""
        return self._transposed(conj=False)

    def conj_transpose(self):
        return self._transposed(conj=True)

    def _transposed(self, conj: bool):
        n, m = self.shape
        k = self.nnz
        dev = self.device
        # the entries are row-major, so a stable sort by column keeps each
        # new row's entries in column order
        rows, cols = self.col_idx[:k].long(), self.row_idx[:k].long()
        order = torch.argsort(rows, stable=True)
        vals = self.values[:k][order]
        cap = self.values.shape[0]
        row_idx = torch.full((cap,), m, dtype=self.row_idx.dtype, device=dev)
        col_idx = torch.zeros(cap, dtype=self.col_idx.dtype, device=dev)
        values = torch.zeros(cap, dtype=self.dtype, device=dev)
        row_idx[:k] = rows[order]
        col_idx[:k] = cols[order]
        values[:k] = vals.conj() if conj else vals
        row_ptr = torch.zeros(m + 1, dtype=self.row_ptr.dtype, device=dev)
        row_ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), dim=0)
        kw = {}
        if self.strategy == "banded" and self.diag_values is not None:
            kw = self._banded_transposed(conj)
        return Csr(row_ptr=row_ptr, col_idx=col_idx, values=values,
                   row_idx=row_idx, shape=(m, n), nnz=k, **kw)

    def _banded_transposed(self, conj: bool) -> dict:
        """The banded layout of the transpose, on the device: negate the
        offsets and shift each diagonal by its offset."""
        from ..ops.spmv_banded import (LANES, plan_banded_layout,
                                       unblock_diag_values)
        meta = dict(self.band_meta)
        n = meta["n"]
        dv = unblock_diag_values(self.diag_values, meta)
        if conj:
            dv = dv.conj()
        offsets = self.diag_offsets
        pairs = sorted((-int(o), d) for d, o in enumerate(offsets))
        new_offsets = tuple(o for o, _ in pairs)
        D = len(offsets)
        meta2 = plan_banded_layout(new_offsets, n)
        G, S, NSp = meta2["G"], meta2["S"], meta2["NSp"]
        shifted = torch.zeros((D, NSp * LANES), dtype=dv.dtype,
                              device=dv.device)
        for row, (_, d) in enumerate(pairs):
            o = int(offsets[d])
            # A[i, i+o] = dv[d, i]  =>  A^T[i, i-o] = dv[d, i-o]
            if o >= 0:
                shifted[row, o:n] = dv[d, :n - o]
            else:
                shifted[row, :n + o] = dv[d, -o:]
        dvb = shifted.reshape(D, G, S, LANES).permute(1, 0, 2, 3).contiguous()
        kw = dict(strategy="banded", diag_offsets=new_offsets,
                  band_meta=tuple(sorted(meta2.items())), diag_values=dvb)
        if self.tail_rows is not None:
            # padding entries (row n) stay padding in the transpose
            pad = self.tail_rows >= n
            tv = self.tail_vals
            kw.update(tail_rows=torch.where(pad, n, self.tail_cols),
                      tail_cols=torch.where(pad, 0, self.tail_rows),
                      tail_vals=tv.conj_physical() if conj else tv)
        return kw

    # -- elementwise maps (every value-carrying array stays consistent) ------
    def _map_values(self, fn):
        """Apply an elementwise map to every value-carrying tensor: the
        classical values, the banded diagonals, the tail, the packed slab
        on the host and its stream on the device (the floating and complex
        tensors the operator holds)."""
        return map_tensors(self, lambda t: fn(t) if t.is_floating_point()
                           or t.is_complex() else t)

    def scale(self, alpha):
        return self._map_values(lambda v: v * _scalar_on(alpha, v))

    def inv_scale(self, alpha):
        """values / alpha (``csr.hpp:1356`` inv_scale)."""
        return self._map_values(lambda v: v / _scalar_on(alpha, v))

    def compute_absolute(self):
        """|A| entrywise (AbsoluteComputable, ``csr.hpp:1192``)."""
        return self._map_values(torch.abs)

    def astype(self, dtype):
        dtype = as_torch_dtype(dtype)
        return self._map_values(lambda v: v.to(dtype))

    def add_scaled_identity(self, alpha, beta):
        """``beta*A + alpha*I`` on the existing pattern (ScaledIdentityAddable,
        ``core/matrix/csr.cpp:1576-1589``).  Like the reference, requires every
        diagonal entry to be structurally present (raises otherwise), and the
        structural pattern is preserved even where the new value is exactly
        zero.  A banded or packed matrix is rebuilt on the host (its layout
        is planned from the values); a classical one is updated on its
        device."""
        rows = self.row_idx[:self.nnz]
        cols = self.col_idx[:self.nnz]
        if int((rows == cols).sum()) < min(self.shape):
            from ..base.exceptions import UnsupportedMatrixProperty
            raise UnsupportedMatrixProperty(
                "add_scaled_identity: matrix has structurally zero "
                "diagonal entries")
        if self.strategy in ("banded", "packed"):
            d = self.to_matrix_data()
            new_vals = beta * d.values + np.where(
                d.row_idx == d.col_idx, alpha, 0).astype(d.values.dtype)
            # pattern-preserving rebuild (entries are already canonical
            # row-major order; _from_canonical_data keeps exact zeros)
            return Csr._from_canonical_data(
                MatrixData(self.shape, d.row_idx, d.col_idx, new_vals),
                strategy="automatical", dtype=self.dtype,
                index_dtype=self.row_idx.dtype, device=self.device)
        on_diag = self.row_idx == self.col_idx
        new = copy.copy(self)
        new.values = beta * self.values + torch.where(
            on_diag, alpha, 0).to(self.values.dtype)
        return new

    # -- sparse algebra ------------------------------------------------------------
    def _algebra_kw(self, other, kw):
        """A product or sum lands on this matrix's device, in the value
        type the two operands promote to, unless the caller says
        otherwise."""
        kw.setdefault("device", self.device)
        kw.setdefault("dtype", torch.promote_types(self.dtype, other.dtype))
        return kw

    def spgemm(self, other, **kwargs):
        """C = self @ other (``csr.cpp`` spgemm): host symbolic, numeric
        routed by this matrix's device and the product's size
        (``ops.spgemm.spgemm_route``). One-shot; for repeated products on
        fixed patterns use ops.spgemm.SpgemmReuse."""
        from ..ops.spgemm import spgemm_data
        return Csr.from_data(
            spgemm_data(self.to_matrix_data(), other.to_matrix_data(),
                        device=self.device),
            **self._algebra_kw(other, kwargs))

    def spgeam(self, alpha, beta, other, **kwargs):
        """C = alpha*self + beta*other (pattern union)."""
        from ..ops.spgemm import spgeam_data
        return Csr.from_data(
            spgeam_data(alpha, self.to_matrix_data(), beta,
                        other.to_matrix_data()),
            **self._algebra_kw(other, kwargs))

    # -- host rebuilds ---------------------------------------------------------------
    def permute(self, perm, mode=None, **kwargs):
        """Symmetric (or mode-selected) permutation (csr.hpp Permutable)."""
        from .permutation import permute_data, permute_mode
        if mode is None:
            mode = permute_mode.symmetric
        if isinstance(perm, torch.Tensor):
            perm = perm.cpu().numpy()
        return Csr.from_data(permute_data(self.to_matrix_data(),
                                          np.asarray(perm), mode),
                             **self._rebuild_kw(kwargs))

    def scale_permute(self, row_sp, mode=None, col_sp=None,
                      invert: bool = False, **kwargs):
        """Scaled permutation (``csr.hpp`` scale_permute): one
        ScaledPermutation + permute_mode, or row/col pair with ``invert``.
        Host-side (build-time), like permute."""
        from .permutation import scale_permute_data
        return Csr.from_data(
            scale_permute_data(self.to_matrix_data(), row_sp, mode=mode,
                               col_sp=col_sp, invert=invert),
            **self._rebuild_kw(kwargs))

    def create_submatrix(self, rows: slice, cols: slice, **kwargs):
        """Extract the [rows, cols] block (csr.cpp submatrix kernels)."""
        d = self.to_matrix_data()
        r0 = rows.start or 0
        r1 = self.shape[0] if rows.stop is None else rows.stop
        c0 = cols.start or 0
        c1 = self.shape[1] if cols.stop is None else cols.stop
        keep = ((d.row_idx >= r0) & (d.row_idx < r1)
                & (d.col_idx >= c0) & (d.col_idx < c1))
        sub = MatrixData((r1 - r0, c1 - c0), d.row_idx[keep] - r0,
                         d.col_idx[keep] - c0, d.values[keep])
        return Csr.from_data(sub, **self._rebuild_kw(kwargs))

    def is_sorted_by_column_index(self) -> bool:
        """Host-side check that every row's columns are ascending
        (``csr.hpp:1207``).  Always true for matrices built through
        MatrixData.canonical(); useful for externally assembled arrays."""
        rows = self.row_idx[:self.nnz].cpu().numpy()
        cols = self.col_idx[:self.nnz].cpu().numpy()
        order = np.lexsort((cols, rows))
        return bool(np.array_equal(order, np.arange(self.nnz))
                    and np.array_equal(rows, np.sort(rows)))

    def sort_by_column_index(self):
        """Return a copy with each row's entries sorted by column index
        (``csr.hpp:1199``; build-time, host side).  A pure reorder like the
        reference: explicit zeros and duplicate coordinates are preserved,
        not canonicalized away."""
        if self.is_sorted_by_column_index():
            return self
        rows = self.row_idx.cpu().numpy()
        cols = self.col_idx.cpu().numpy()
        # padded slots carry row == n, so lexsort keeps them at the end
        order = torch.from_numpy(np.lexsort((cols, rows))).to(self.device)
        new = copy.copy(self)
        new.row_idx = self.row_idx[order]
        new.col_idx = self.col_idx[order]
        new.values = self.values[order]
        return new

    # row lengths (for strategy decisions / ELL conversion)
    def row_lengths(self):
        return self.row_ptr[1:] - self.row_ptr[:-1]


def _values_numpy(values) -> np.ndarray:
    """Host copy of a value tensor (bf16 widened to f32: numpy has none)."""
    if values.dtype == torch.bfloat16:
        values = values.float()
    return values.cpu().numpy()


# ---------------------------------------------------------------------------
# Strategy processing (build-time, host side) — strategy_type::process analog.
# Verbatim from ginkgo_tpu/matrix/csr.py with the same constants, which were
# tuned on the TPU; both packages plan identical layouts.
# ---------------------------------------------------------------------------

_BANDED_MAX_DIAGS = 64        # cap aux storage at 64 diagonals
_BANDED_MIN_FILL = 0.55       # required nnz density along kept diagonals


# tail acceptance: keep the tail under ~0.05% of the band work
_TAIL_FRACTION = 5e-4


def _process_strategy(strategy: str, d: MatrixData, values_np: np.ndarray):
    """Decide the kernel layout and precompute its aux arrays.

    Returns (strategy, offsets, meta, blocked_diag_values, tail) where tail
    is None or (rows, cols, vals) of off-band outliers."""
    if strategy not in ("classical", "banded", "automatical", "packed",
                        "load_balance", "merge_path", "sparselib"):
        raise ValueError(f"unknown CSR strategy {strategy!r}")
    # merge_path/load_balance/sparselib resolve to the classical path, as
    # in the JAX package.
    if strategy in ("load_balance", "merge_path", "sparselib", "classical"):
        return "classical", None, None, None, None, None
    if strategy == "packed":
        # explicit request: skip the automatical pad-ratio economy check
        # (the JAX package's rule, kept so both plan alike); only the
        # tail cap (layout correctness economics) still applies
        pell = _process_packed(d, values_np, max_pad=float("inf"))
        if pell is not None:
            return ("packed", None, None, None, pell[1], pell[0])
        return "classical", None, None, None, None, None

    n, m = d.shape
    if n != m or d.nnz == 0:
        return "classical", None, None, None, None, None
    diag_of = d.col_idx.astype(np.int64) - d.row_idx
    offsets, counts = np.unique(diag_of, return_counts=True)

    tail_mask = None
    if strategy == "automatical":
        # keep reasonably dense diagonals (boundary-clipped stencil
        # diagonals included); spill sparse outliers to the COO tail
        dense_enough = counts >= 0.3 * n
        chosen = offsets[dense_enough]
        if chosen.size > _BANDED_MAX_DIAGS:
            order = np.argsort(-counts[dense_enough])[:_BANDED_MAX_DIAGS]
            chosen = np.sort(chosen[order])
        if chosen.size == 0:
            return _fallback_general(d, values_np)
        kept_nnz = counts[np.isin(offsets, chosen)].sum()
        # banded only pays when the kept diagonals are collectively dense
        if kept_nnz / (chosen.size * n) < _BANDED_MIN_FILL:
            return _fallback_general(d, values_np)
        tail_nnz = d.nnz - kept_nnz
        if tail_nnz > max(64, _TAIL_FRACTION * chosen.size * n):
            return _fallback_general(d, values_np)
        if tail_nnz:
            tail_mask = ~np.isin(diag_of, chosen)
        offsets = chosen
    if offsets.size > 4096:
        return _fallback_general(d, values_np)

    # Build (num_diags, n) diagonal value array indexed by row, then block it
    # into the pipeline layout the Pallas kernel consumes.
    from ..ops.spmv_banded import block_diag_values, plan_banded_layout
    keep = (~tail_mask) if tail_mask is not None else slice(None)
    diag_values = np.zeros((offsets.size, n), values_np.dtype)
    diag_idx = np.searchsorted(offsets, diag_of[keep])
    diag_values[diag_idx, d.row_idx[keep]] = values_np[keep]
    offsets_t = tuple(int(o) for o in offsets)
    meta = plan_banded_layout(offsets_t, n)
    dvb = block_diag_values(diag_values, meta)
    tail = None
    if tail_mask is not None:
        tail = (d.row_idx[tail_mask], d.col_idx[tail_mask],
                values_np[tail_mask])
    return ("banded", offsets_t, tuple(sorted(meta.items())), dvb, tail,
            None)


# packed-layout acceptance: the DMA streams pad_ratio x the useful
# bytes, so beyond ~6x padding the classical gather path wins back
_PACKED_MAX_PAD = 6.0
_PACKED_MAX_TAIL = 0.05


def _process_packed(d: MatrixData, values_np: np.ndarray,
                    max_pad: float = _PACKED_MAX_PAD):
    """(layout, tail) for the packed-slot windowed-ELL general-matrix
    path, or None when the matrix does not fit its static bounds."""
    from ..ops.spmv_packed import plan_packed_layout
    mp = None if max_pad == float("inf") else max_pad
    layout, tail, stats = plan_packed_layout(d, values_np, max_pad=mp,
                                             max_tail=_PACKED_MAX_TAIL)
    if layout is None:
        return None
    if (stats["pad_ratio"] > max_pad
            or stats["tail_nnz"] > _PACKED_MAX_TAIL * max(d.nnz, 1)):
        return None
    if tail is not None and len(tail[0]) == 0:
        tail = None
    return layout, tail


def _fallback_general(d: MatrixData, values_np: np.ndarray):
    """automatical, non-banded case: packed-slot layout when it fits,
    classical otherwise (csr.hpp automatical analog)."""
    pell = _process_packed(d, values_np)
    if pell is not None:
        return "packed", None, None, None, pell[1], pell[0]
    if d.nnz >= 1 << 16:
        # large matrix on the gather path: tell the user the framework's
        # prescription (performance_hint.hpp analog)
        from ..log.logger import PERFORMANCE_FALLBACK, dispatch
        dispatch(PERFORMANCE_FALLBACK, kernel="csr_spmv",
                 reason="no column locality for the banded/packed layouts"
                        " — the classical path gathers entry by entry;"
                        " apply Rcm/NestedDissection reordering first")
    return "classical", None, None, None, None, None
