"""MC64 — maximum-weight bipartite matching permutation + scaling
(``ginkgo_tpu/reorder/mc64.py`` in torch).

Analog of ``include/ginkgo/core/reorder/mc64.hpp:77`` /
``core/reorder/mc64.cpp`` (the HSL MC64 algorithm): permute rows so the
product (or sum) of diagonal magnitudes is maximised, with row/column
scalings recovered from the LP dual potentials so that the matched
diagonal becomes exactly 1 and EVERY scaled entry obeys |b_ij| <= 1 —
the standard stabiliser before pivot-free sparse LU.

Implementation: sparse shortest-augmenting-path assignment
(Duff-Koster / sparse Jonker-Volgenant) on the reduced weights
``c_ij = max_k log2|a_ik| - log2|a_ij|`` with column dual potentials,
matching the reference's weight/dual/scaling conventions exactly
(log2/exp2, per-row maxima reversal, ``compute_scaling`` at
``core/reorder/mc64.cpp:428``).  The matching runs in the native C++
tier (``gt_mc64_match``) with a pure-Python heap fallback; everything
else is vectorized numpy.  No dense (n, n) arrays anywhere.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..device import matrix_data_and_device
from ..matrix.permutation import ScaledPermutation
from ..native import mc64_match_native


def _prepare(d, strategy):
    """CSR arrays + minimization weights c >= 0 + initial column duals.

    Product strategy: c_ij = row_max_i - log2|a_ij| (inf for zeros);
    sum strategy: c_ij = row_max_i - |a_ij|.
    """
    n = d.shape[0]
    rows = d.row_idx.astype(np.int64)
    ptr = np.searchsorted(rows, np.arange(n + 1)).astype(np.int64)
    cols = d.col_idx.astype(np.int64)
    absval = np.abs(d.values).astype(np.float64)
    if strategy == "max_diagonal_product":
        with np.errstate(divide="ignore"):
            w = np.log2(absval)
    elif strategy == "max_diagonal_sum":
        w = absval
    else:
        raise ValueError(f"unknown mc64 strategy {strategy!r}")
    row_max = np.full(n, -np.inf)
    np.maximum.at(row_max, rows, w)
    if not np.isfinite(row_max).all():
        raise ValueError("mc64: matrix has an empty (all-zero) row")
    c = row_max[rows] - w                   # inf where a_ij == 0
    u0 = np.full(n, np.inf)
    np.minimum.at(u0, cols, c)
    if not np.isfinite(u0).all():
        raise ValueError("mc64: matrix has an empty (all-zero) column")
    return n, ptr, cols, c, u0, row_max, w


def _match_python(n, ptr, cols, c, u, tol):
    """Heap-based SAP fallback (same algorithm as gt_mc64_match)."""
    inf = np.inf
    p = np.full(n, -1, np.int64)
    ip = np.full(n, -1, np.int64)
    midx = np.full(n, -1, np.int64)
    for r in range(n):
        for e in range(ptr[r], ptr[r + 1]):
            j = cols[e]
            if ip[j] < 0 and abs(c[e] - u[j]) < tol:
                p[r] = j
                ip[j] = r
                midx[r] = e
                break
    for r0 in range(n):
        if p[r0] >= 0:
            continue
        dist = np.full(n, inf)
        done = np.zeros(n, bool)
        pred_row = np.full(n, -1, np.int64)
        pred_edge = np.full(n, -1, np.int64)
        pq = []

        def relax(i, base, vi):
            for e in range(ptr[i], ptr[i + 1]):
                j = cols[e]
                if done[j] or c[e] == inf:
                    continue
                nd = base + (c[e] - u[j]) - vi
                if nd < dist[j]:
                    dist[j] = nd
                    pred_row[j] = i
                    pred_edge[j] = e
                    heapq.heappush(pq, (nd, j))

        lsap, sink = inf, -1
        relax(r0, 0.0, 0.0)
        while pq:
            dj, j = heapq.heappop(pq)
            if done[j] or dj > dist[j]:
                continue
            done[j] = True
            if ip[j] < 0:
                lsap, sink = dj, j
                break
            i = ip[j]
            relax(i, dj, c[midx[i]] - u[p[i]])
        if sink < 0:
            raise ValueError("mc64: structurally singular matrix")
        fin = np.flatnonzero(done)
        upd = fin[fin != sink]
        u[upd] += dist[upd] - lsap
        j = sink
        while True:
            i = pred_row[j]
            jprev = p[i]
            p[i] = j
            ip[j] = i
            midx[i] = pred_edge[j]
            if i == r0:
                break
            j = jprev
    return p, ip, midx, u


def _match(n, ptr, cols, c, u0, tol):
    res = mc64_match_native(n, ptr, cols, c, u0.copy(), tol)
    if res is not None:
        ok, p, ip, midx, u = res
        if not ok:
            raise ValueError("mc64: structurally singular matrix")
        return p, ip, midx, u
    return _match_python(n, ptr, cols, c, u0.copy(), tol)


def mc64_matching(data, strategy: str = "max_diagonal_product",
                  tolerance: float = None):
    """Returns (perm, row_scale, col_scale): ``perm[k]`` is the source
    row moved to row k (so ``B = diag(rs)[perm-applied] A diag(cs)`` has
    the matched entries, scaled to magnitude 1, on the diagonal).

    ``row_scale`` is indexed in DESTINATION order (our ScaledPermutation
    applies ``scale * b[perm]``); the reference stores it in source
    order attached to the same inverse permutation — same operator.
    """
    d = data.canonical()
    if d.shape[0] != d.shape[1]:
        raise ValueError("mc64 needs a square matrix")
    if tolerance is None:
        tolerance = 50 * np.finfo(np.float64).eps
    n, ptr, cols, c, u0, row_max, w = _prepare(d, strategy)
    p, ip, midx, u = _match(n, ptr, cols, c, u0, float(tolerance))
    if strategy == "max_diagonal_product":
        # compute_scaling (mc64.cpp:428): col j scaled by 2^u_j, row i by
        # 2^(c(i, p_i) - u(p_i) - row_max_i) = 2^(-log2|a_i,p_i| - u(p_i))
        col_scale = np.exp2(u)
        row_scale_src = np.exp2(c[midx] - u[p] - row_max)
    else:
        col_scale = np.ones(n)
        row_scale_src = np.ones(n)
    # destination-order row scale for our apply convention
    return ip, row_scale_src[ip], col_scale


class Mc64Result:
    """Row/column scaled permutations (the reference returns a
    Composition of two ScaledPermutations: (row_scaling, inv_perm) and
    (col_scaling, identity) — ``core/reorder/mc64.cpp:578``).

    Exposes ``.perm``/``.scale`` (the row operator, host arrays) so
    generic consumers (ScaledReordered) keep working, plus ``unpack()``
    for both sides as operators on ``device``.
    """

    def __init__(self, perm, row_scale, col_scale, device=None):
        self.perm = np.asarray(perm)
        self.scale = np.asarray(row_scale)
        self.col_scale = np.asarray(col_scale)
        self.device = device

    def unpack(self):
        n = self.perm.shape[0]
        row_op = ScaledPermutation.from_indices(self.perm, self.scale,
                                                device=self.device)
        col_op = ScaledPermutation.from_indices(np.arange(n),
                                                self.col_scale,
                                                device=self.device)
        return row_op, col_op


class Mc64:
    """Factory: ``Mc64.build().generate(A)`` -> Mc64Result."""

    def __init__(self, strategy: str = "max_diagonal_product",
                 tolerance: float = None):
        self.strategy = strategy
        self.tolerance = tolerance

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> Mc64Result:
        data, device = matrix_data_and_device(A)
        perm, rs, cs = mc64_matching(data, self.strategy,
                                     self.tolerance)
        return Mc64Result(perm, rs, cs, device)
