"""PGM — parallel graph match aggregation (``ginkgo_tpu/multigrid/pgm.py``
in torch).

Analog of ``include/ginkgo/core/multigrid/pgm.hpp:51`` /
``core/multigrid/pgm.cpp:187-260`` (kernels find_strongest_neighbor,
match_edge, count_unagg, assign_to_exist_agg, renumber) and the
sort-reduce Galerkin product ``generate_coarse`` (pgm.cpp:93-152).

Aggregation runs on the operand's device for the structured classes
(``pgm_dia.py``, ``pgm_packed.py``) and in host numpy otherwise; the
level operators live on the fine operator's device: prolongation =
gather by aggregate id, restriction = ``index_add_`` by aggregate id
(unsmoothed aggregation, P entries = 1), or, on levels of at least 8,192
rows, both as packed ``Csr`` operators (kernel B); coarse operator =
index-map + sum-duplicates (RᵀAP as one sort-reduce).

Routing follows the operand's device where the reference asks
``jax.default_backend()``: ``auto`` on a CUDA operand of at least 16,384
rows tries ``dia``, then ``packed``, then the host path.  A matcher named
explicitly that declines a CUDA operand raises ``NotSupportedError``
(the host path would move the work to the CPU unseen).  The level
records the path taken in ``route``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.exceptions import NotSupportedError
from ..base.linop import LinOp
from ..base.matrix_data import MatrixData
from ..device import matrix_data_and_device, resolve_device
from ..matrix.csr import Csr


class AggProlong(LinOp):
    """x_fine = x_coarse[agg] — unsmoothed-aggregation prolongation.

    ``op`` optionally holds the same map as a fast-layout Csr (the P
    matrix), applied by the SpMV kernels instead of a gather."""

    def __init__(self, agg, num_coarse: int, op=None):
        self.agg = agg                    # (n_fine,) aggregate id per row
        self.num_coarse = int(num_coarse)
        self.op = op

    @property
    def shape(self):
        return (self.agg.shape[0], self.num_coarse)

    def _apply(self, b):
        if self.op is not None:
            return self.op._apply(b)
        return b[self.agg]


class AggRestrict(LinOp):
    """x_coarse = segment sum of x_fine by agg — Pᵀ."""

    def __init__(self, agg, num_coarse: int, op=None):
        self.agg = agg
        self.num_coarse = int(num_coarse)
        self.op = op

    @property
    def shape(self):
        return (self.num_coarse, self.agg.shape[0])

    def _apply(self, b):
        if self.op is not None:
            return self.op._apply(b)
        out = torch.zeros((self.num_coarse, b.shape[1]), dtype=b.dtype,
                          device=b.device)
        return out.index_add_(0, self.agg, b)


def _coarse_csr(coarse_data: MatrixData, device) -> Csr:
    """Coarse Galerkin operator on the fastest accepted layout: automatical
    (banded/packed within economy caps) with an explicit-packed retry —
    aggregation densifies rows, which pushes mid-level pad ratios just
    past the automatical cap while the packed stream still beats the
    gather by orders of magnitude."""
    C = Csr.from_data(coarse_data, strategy="automatical", device=device)
    if C.strategy == "classical" and coarse_data.nnz >= (1 << 14):
        C2 = Csr.from_data(coarse_data, strategy="packed", device=device)
        if C2.strategy == "packed":
            return C2
    return C


def _agg_transfer_ops(agg: np.ndarray, nc: int, device, dtype):
    """(P, R) as packed-strategy Csr operators with ``dtype`` ones, or
    (None, None) when the fast layouts reject the pattern (classical
    would just re-gather)."""
    n = agg.shape[0]
    if n < (1 << 13):
        return None, None
    rows = np.arange(n, dtype=np.int64)
    cols = np.asarray(agg, np.int64)
    ones = np.ones(n)
    # explicit 'packed': a one-entry-per-row transfer pads ~8x in the
    # slot layout, but the padded stream still beats the gather
    P = Csr.from_data(MatrixData((n, nc), rows, cols, ones),
                      strategy="packed", dtype=dtype, device=device)
    R = Csr.from_data(MatrixData((nc, n), cols, rows, ones),
                      strategy="packed", dtype=dtype, device=device)
    if P.strategy == "classical" and R.strategy == "classical":
        return None, None
    return (P if P.strategy != "classical" else None,
            R if R.strategy != "classical" else None)


class MultigridLevel(LinOp):
    """(fine op, prolong, restrict, coarse op) bundle
    (``multigrid_level.hpp`` EnableMultigridLevel); ``route`` is the
    aggregation path that made it (``dia``, ``packed``, ``host``, or
    ``fixed`` for ``FixedCoarsening``)."""

    def __init__(self, fine_op, prolong, restrict, coarse_op, route="host"):
        self.fine_op = fine_op
        self.prolong = prolong
        self.restrict = restrict
        self.coarse_op = coarse_op
        self.route = route

    @property
    def shape(self):
        return self.fine_op.shape

    def _apply(self, b):
        return self.fine_op._apply(b)


def _renumber(agg: np.ndarray, n: int) -> np.ndarray:
    """Dense ids in fine-row-first-appearance order: ids in matching
    order are spatially scattered, which strips the coarse Galerkin
    operator (and P/R) of the column locality the banded/packed layouts
    need — with first-appearance ordering a banded fine matrix stays
    banded on every coarse level."""
    uniq, inv = np.unique(agg, return_inverse=True)
    first = np.full(uniq.size, n, np.int64)
    np.minimum.at(first, inv, np.arange(n))
    rank = np.empty(uniq.size, np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(uniq.size)
    return rank[inv].astype(np.int64)


def _declined(algorithm, device, path):
    """The ``path`` matcher declined the matrix: ``auto`` goes on; a
    caller who named ``path`` for a CUDA operand gets an error."""
    if algorithm == path and device.type == "cuda":
        raise NotSupportedError(
            f"Pgm(algorithm={path!r}): the {path} matcher declines this "
            f"matrix; algorithm='auto' or 'general' takes the host path")


def aggregate(data: MatrixData, max_iterations: int = 15,
              max_unassigned_ratio: float = 0.05,
              deterministic: bool = True, seed: int = 0,
              algorithm: str = "auto", device=None):
    """(agg id per row, route): ``pgm_aggregate`` with the path it took."""
    d = data.canonical()
    n = d.shape[0]
    if algorithm not in ("auto", "dia", "packed", "general"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    device = resolve_device(device)
    # device matching: DIA slabs for diagonal-structured matrices
    # (pgm_dia.py), padded-ELL for general unstructured (pgm_packed.py)
    if algorithm != "general" and deterministic:
        auto = algorithm == "auto" and device.type == "cuda" and n >= 16384
        if algorithm == "dia" or auto:
            from .pgm_dia import aggregate_dia
            root = aggregate_dia(d, max_iterations, device=device)
            if root is not None:
                return _renumber(root, n), "dia"
            _declined(algorithm, device, "dia")
        if algorithm == "packed" or auto:
            from .pgm_packed import aggregate_packed
            root = aggregate_packed(d, max_iterations, device=device)
            if root is not None:
                return _renumber(root, n), "packed"
            _declined(algorithm, device, "packed")
    return _host_aggregate(d, max_iterations, max_unassigned_ratio,
                           deterministic, seed), "host"


def pgm_aggregate(data: MatrixData, max_iterations: int = 15,
                  max_unassigned_ratio: float = 0.05,
                  deterministic: bool = True, seed: int = 0,
                  algorithm: str = "auto", device=None) -> np.ndarray:
    """Size-2 mutual-strongest-edge aggregation. Returns agg id per row.
    ``device`` (default: the card) is where a device matcher runs and
    what ``auto`` routes by."""
    return aggregate(data, max_iterations, max_unassigned_ratio,
                     deterministic, seed, algorithm, device)[0]


def _host_aggregate(d, max_iterations, max_unassigned_ratio, deterministic,
                    seed):
    """The host edge-list matching (numpy and scipy, the reference's)."""
    import scipy.sparse as sp
    n = d.shape[0]
    # symmetrised off-diagonal weight matrix (pgm.cpp builds 0.5(A+Aᵀ))
    off = d.row_idx != d.col_idx
    w = sp.csr_matrix((np.abs(d.values[off]),
                       (d.row_idx[off], d.col_idx[off])), shape=(n, n))
    w = (w + w.T) * 0.5
    w = w.tocsr()
    wc = w.tocoo()
    e_rows = wc.row.astype(np.int64)
    e_cols = wc.col.astype(np.int64)
    e_vals = wc.data

    def _strongest(rows, cols, row_ok, col_ok):
        """Per-row argmax over edges with row_ok[row] & col_ok[col].  The
        edge list is presorted ONCE by (row asc, value desc, tiebreak asc)
        below, and boolean compaction preserves that order — so each round
        is just a mask + first-occurrence-per-row scan, no per-round sort."""
        keep = row_ok[rows] & col_ok[cols]
        r, c = rows[keep], cols[keep]
        out = np.full(n, -1, np.int64)
        if r.size == 0:
            return out
        first = np.empty(r.size, bool)
        first[0] = True
        np.not_equal(r[1:], r[:-1], out=first[1:])
        out[r[first]] = c[first]
        return out

    # SYMMETRIC per-edge tiebreak (same value for (i,j) and (j,i)):
    # mutual-strongest matching on constant-coefficient stencils, where
    # every weight ties, pairs a constant fraction of vertices a round
    # (Luby-style matching) only with a symmetric tiebreak.
    ekey = np.minimum(e_rows, e_cols) * n + np.maximum(e_rows, e_cols)
    if deterministic:
        e_tb = (ekey.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
                ).astype(np.int64) & np.int64(0x7FFFFFFFFFFFFFF)
    else:
        rng_tb = np.random.default_rng(seed)
        h = rng_tb.permutation(1 << 20)
        e_tb = h[ekey % (1 << 20)]

    # one-time sort establishing _strongest's per-row best-first invariant
    order = np.lexsort((e_tb, -e_vals, e_rows))
    e_rows, e_cols = e_rows[order], e_cols[order]

    agg = np.full(n, -1, np.int64)
    next_id = 0
    # live edges = both endpoints still unassigned; compacted every round
    # so each scan only pays for the shrinking frontier
    lr, lc = e_rows, e_cols
    ones = np.ones(n, bool)
    for _ in range(max_iterations):
        free = agg < 0
        if free.sum() <= max_unassigned_ratio * n:
            break
        # strongest unassigned neighbor of each unassigned vertex, then
        # match mutual-strongest pairs (pgm.cpp find_strongest_neighbor /
        # match_edge) — ids assigned in ascending-i order like the
        # reference's sequential sweep
        strongest = _strongest(lr, lc, ones, ones)
        i_arr = np.nonzero(strongest >= 0)[0]
        j_arr = strongest[i_arr]
        mutual = (strongest[j_arr] == i_arr) & (i_arr < j_arr)
        pi, pj = i_arr[mutual], j_arr[mutual]
        if pi.size == 0:
            break
        ids = next_id + np.arange(pi.size)
        agg[pi] = ids
        agg[pj] = ids
        next_id += pi.size
        live = (agg[lr] < 0) & (agg[lc] < 0)
        lr, lc = lr[live], lc[live]
    # assign leftovers to their strongest aggregated neighbor; iterate so
    # chains resolve, but only into aggregates still below the size cap
    max_agg_size = 8
    while True:
        free = agg < 0
        if not free.any():
            break
        sizes = np.bincount(agg[~free], minlength=max(next_id, 1))
        ok_target = ~free
        ok_target[~free] &= sizes[agg[~free]] < max_agg_size
        strongest = _strongest(e_rows, e_cols, free, ok_target)
        attach = np.nonzero(strongest >= 0)[0]
        if attach.size == 0:
            break
        agg[attach] = agg[strongest[attach]]
        # edges from still-free rows only
        keep = agg[e_rows] < 0
        e_rows, e_cols = e_rows[keep], e_cols[keep]
    rest = np.nonzero(agg < 0)[0]
    agg[rest] = next_id + np.arange(rest.size)
    return _renumber(agg, n)


def galerkin_coarse(data: MatrixData, agg: np.ndarray,
                    num_coarse: int) -> MatrixData:
    """Coarse operator RᵀAP by index mapping + sum-duplicates."""
    d = data.canonical()
    return MatrixData((num_coarse, num_coarse), agg[d.row_idx],
                      agg[d.col_idx], d.values).canonical()


def _fine_op(A, data, device):
    return A if isinstance(A, LinOp) else Csr.from_data(data, device=device)


class Pgm:
    """Factory: ``Pgm(max_iterations=15).generate(A)`` -> MultigridLevel,
    every operator on A's device (a port operator's, else the card)."""

    def __init__(self, max_iterations: int = 15,
                 max_unassigned_ratio: float = 0.05,
                 deterministic: bool = True, algorithm: str = "auto"):
        self.max_iterations = max_iterations
        self.max_unassigned_ratio = max_unassigned_ratio
        self.deterministic = deterministic
        self.algorithm = algorithm

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> MultigridLevel:
        data, device = matrix_data_and_device(A)
        agg, route = aggregate(data, self.max_iterations,
                               self.max_unassigned_ratio, self.deterministic,
                               algorithm=self.algorithm, device=device)
        nc = int(agg.max()) + 1 if agg.size else 1
        coarse = _coarse_csr(galerkin_coarse(data, agg, nc), device)
        agg_t = torch.from_numpy(agg).to(device)
        P_op, R_op = _agg_transfer_ops(agg, nc, device, coarse.dtype)
        return MultigridLevel(
            fine_op=_fine_op(A, data, device),
            prolong=AggProlong(agg_t, nc, op=P_op),
            restrict=AggRestrict(agg_t, nc, op=R_op),
            coarse_op=coarse, route=route)


class FixedCoarsening:
    """User-supplied coarse row subset (``fixed_coarsening.hpp``): coarse
    space = selected rows; P = selection-scatter, R = selection-gather."""

    def __init__(self, coarse_rows):
        self.coarse_rows = np.asarray(coarse_rows, np.int64)

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> MultigridLevel:
        data, device = matrix_data_and_device(A)
        n = data.shape[0]
        sel = self.coarse_rows
        nc = sel.shape[0]
        # selected rows -> own id; the others map past the coarse space
        # and are dropped (simple injection)
        agg = np.full(n, nc, np.int64)
        agg[sel] = np.arange(nc)
        d = data.canonical()
        keep = (agg[d.row_idx] < nc) & (agg[d.col_idx] < nc)
        coarse_data = MatrixData((nc, nc), agg[d.row_idx[keep]],
                                 agg[d.col_idx[keep]],
                                 d.values[keep]).canonical()
        sel_t = torch.from_numpy(sel).to(device)
        return MultigridLevel(
            fine_op=_fine_op(A, data, device),
            prolong=_SelProlong(sel_t, n),
            restrict=_SelRestrict(sel_t, n),
            coarse_op=_coarse_csr(coarse_data, device), route="fixed")


class _SelProlong(LinOp):
    def __init__(self, sel, n_fine: int):
        self.sel = sel
        self.n_fine = int(n_fine)

    @property
    def shape(self):
        return (self.n_fine, self.sel.shape[0])

    def _apply(self, b):
        out = torch.zeros((self.n_fine, b.shape[1]), dtype=b.dtype,
                          device=b.device)
        out[self.sel] = b
        return out


class _SelRestrict(LinOp):
    def __init__(self, sel, n_fine: int):
        self.sel = sel
        self.n_fine = int(n_fine)

    @property
    def shape(self):
        return (self.sel.shape[0], self.n_fine)

    def _apply(self, b):
        return b[self.sel]
