"""ParILU / ParIC — fixed-point incomplete factorization, and the exact
ILU(0)/IC(0) host reference (``ginkgo_tpu/factorization/par_ilu.py`` in
torch).

Analog of ``core/factorization/par_ilu.cpp`` (Chow-Patel asynchronous sweeps,
``include/ginkgo/core/factorization/par_ilu.hpp:70``), ``par_ic.hpp:69``, and
the exact-pattern ``core/factorization/{ilu,ic}.cpp`` (sparselib ILU0 analog).

The sweep update for every pattern entry (i,j)

    s_ij = a_ij - sum_{k < min(i,j)} l_ik u_kj
    l_ij = s_ij / u_jj   (i > j)        u_ij = s_ij   (i <= j)

is data-parallel over entries once the sparse dot products are *compiled
away*: at generate time (host, symbolic) every contributing
(l_idx, u_idx, out_idx) triple is enumerated, and a sweep becomes one
gather-multiply + ``index_add_`` on the factor's device (a Jacobi-style
functional update, which is also a valid Chow-Patel iteration).  On CUDA
``index_add_`` sums in no fixed order, so factors differ from run to run in
the last bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.matrix_data import MatrixData
from ..device import matrix_data_and_device
from ..matrix.csr import Csr
from .container import Factorization


# ---------------------------------------------------------------------------
# Symbolic phase (host): ILU(0) pattern split + contribution-pair lists
# ---------------------------------------------------------------------------

def _split_pattern(data: MatrixData):
    """A's pattern -> (L strict-lower+unit-diag pattern, U upper pattern)."""
    d = data.canonical()
    n = d.shape[0]
    r, c = d.row_idx.astype(np.int64), d.col_idx.astype(np.int64)
    lower = r > c
    upper = r <= c
    lr, lc = r[lower], c[lower]
    ur, uc = r[upper], c[upper]
    # ensure a full diagonal in U (zero-filled where A lacks it)
    have_diag = np.zeros(n, bool)
    have_diag[ur[ur == uc]] = True
    missing = np.nonzero(~have_diag)[0]
    ur = np.concatenate([ur, missing])
    uc = np.concatenate([uc, missing])
    return d, (lr, lc), (ur, uc)


def _pair_lists(lr, lc, ur, uc, n):
    """All (l_idx, u_idx) with lc[l_idx]==ur[u_idx]=k, k<min(row,col), for
    each output entry — the csr_lookup analog, done once on the host
    (C++ native path with a pure-Python fallback)."""
    from ..native import ilu_pairs_native
    native = ilu_pairs_native(n, lr, lc, ur, uc)
    if native is not None:
        return native
    import collections
    by_row_L = collections.defaultdict(list)   # row -> [(col k, l_idx)]
    for idx, (i, k) in enumerate(zip(lr, lc)):
        by_row_L[i].append((k, idx))
    by_col_U = collections.defaultdict(dict)   # col -> {row k: u_idx}
    for idx, (k, j) in enumerate(zip(ur, uc)):
        by_col_U[j][k] = idx

    def pairs_for(i, j):
        lim = min(i, j)
        ucol = by_col_U.get(j)
        if not ucol:
            return
        for (k, lidx) in by_row_L.get(i, ()):
            if k < lim:
                uidx = ucol.get(k)
                if uidx is not None:
                    yield lidx, uidx

    out_l, out_u, out_o = [], [], []
    # L entries are outputs 0..nnz_l-1; U entries nnz_l..nnz_l+nnz_u-1
    for o, (i, j) in enumerate(zip(lr, lc)):
        for lidx, uidx in pairs_for(i, j):
            out_l.append(lidx)
            out_u.append(uidx)
            out_o.append(o)
    nl = len(lr)
    for o, (i, j) in enumerate(zip(ur, uc)):
        for lidx, uidx in pairs_for(i, j):
            out_l.append(lidx)
            out_u.append(uidx)
            out_o.append(nl + o)
    return (np.asarray(out_l, np.int64), np.asarray(out_u, np.int64),
            np.asarray(out_o, np.int64))


class ParIlu:
    """Factory: ``ParIlu(iterations=5).generate(A)`` -> Factorization.

    ``iterations``: number of fixed-point sweeps (par_ilu.hpp
    ``iterations``); the sweeps run on A's device.
    """

    def __init__(self, iterations: int = 5):
        self.iterations = iterations

    def generate(self, A) -> Factorization:
        data, device = matrix_data_and_device(A)
        d, (lr, lc), (ur, uc) = _split_pattern(data)
        n = d.shape[0]
        pl, pu, po = _pair_lists(lr, lc, ur, uc, n)

        # initial values: a_ij on pattern (0 where U diag was filled);
        # canonical order means akey is a sorted unique map
        akey = d.row_idx.astype(np.int64) * n + d.col_idx
        from .par_ilut import _sorted_lookup
        lv = _sorted_lookup(akey, d.values,
                            lr * n + lc).astype(d.values.dtype)
        uv = _sorted_lookup(akey, d.values,
                            ur * n + uc).astype(d.values.dtype)
        # diag positions in U for the division
        udiag_pos = np.full(n, -1, np.int64)
        on_diag = ur == uc
        udiag_pos[ur[on_diag]] = np.flatnonzero(on_diag)

        # Chow-Patel scaled initial guess l_ij = a_ij / a_jj: the pure
        # Jacobi form of the sweep diverges from raw a_ij on the 27-point
        # Poisson M-matrix, and settles from the scaled start (Chow &
        # Patel 2015).  _split_pattern guarantees every row a U diagonal.
        assert (udiag_pos >= 0).all(), "row(s) missing U diagonal"
        udiag = uv[udiag_pos]
        denom = np.where(udiag == 0, np.ones_like(udiag), udiag)
        lv_init = (lv / denom[lc]).astype(d.values.dtype)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        lv_d, uv_d = _sweeps_kernel(
            put(lv_init), put(uv), put(lv), put(uv), put(pl), put(pu),
            put(po), put(lc), put(udiag_pos), int(self.iterations))

        return _build_factors(n, lr, lc, lv_d.cpu().numpy(), ur, uc,
                              uv_d.cpu().numpy(), d.values.dtype, device)


def _sweeps_kernel(lv, uv, la, ua, pl, pu, po, lcols, udiag_pos,
                   iterations):
    """``iterations`` Jacobi sweeps over the pair lists; ``la``/``ua`` are
    A's values on the L and U patterns."""
    nl = la.shape[0]
    nout = nl + ua.shape[0]
    for _ in range(iterations):
        contrib = torch.zeros(nout, dtype=lv.dtype, device=lv.device)
        contrib.index_add_(0, po, lv[pl] * uv[pu])
        s_l = la - contrib[:nl]
        s_u = ua - contrib[nl:]
        udiag = uv[udiag_pos]
        udiag = torch.where(udiag == 0, torch.ones_like(udiag), udiag)
        lv, uv = s_l / udiag[lcols], s_u
    return lv, uv


def _build_factors(n, lr, lc, lv, ur, uc, uv, dtype, device):
    # L gets a unit diagonal appended
    diag = np.arange(n)
    l_data = MatrixData((n, n),
                        np.concatenate([lr, diag]),
                        np.concatenate([lc, diag]),
                        np.concatenate([lv, np.ones(n, dtype)]))
    u_data = MatrixData((n, n), ur, uc, uv)
    L = Csr.from_data(l_data, strategy="classical", device=device)
    U = Csr.from_data(u_data, strategy="classical", device=device)
    return Factorization(l_factor=L, u_factor=U)


def _ic_sweeps_kernel(la, lv0, p1, p2, po, dpos, isd, lr, lc, iterations):
    lv = lv0
    for _ in range(iterations):
        contrib = torch.zeros(la.shape[0], dtype=lv.dtype, device=lv.device)
        contrib.index_add_(0, po, lv[p1] * torch.conj(lv[p2]))
        s = la - contrib
        diag_new = torch.sqrt(torch.abs(s[dpos])).to(lv.dtype)
        diag_new = torch.where(diag_new == 0, torch.ones_like(diag_new),
                               diag_new)
        lv = torch.where(isd, diag_new[lr], s / diag_new[lc])
    return lv


def _factor_pair(l_data, device):
    """(L, Lᴴ) classical Csr factors of an IC factorization."""
    L = Csr.from_data(l_data, strategy="classical", device=device)
    Lt = Csr.from_data(l_data.conj_transpose().sort_row_major(),
                       strategy="classical", device=device)
    return Factorization(l_factor=L, u_factor=Lt, symmetric=True)


class ParIc:
    """Factory: ParIC fixed-point incomplete Cholesky
    (``include/ginkgo/core/factorization/par_ic.hpp:69``).

    Sweep for lower-pattern entries (j <= i):
        s_ij = a_ij - sum_{k<j} l_ik l_jk
        l_ij = s_ij / l_jj (i > j);  l_jj = sqrt(s_jj)
    """

    def __init__(self, iterations: int = 5, both_factors: bool = True):
        self.iterations = iterations
        self.both_factors = both_factors

    def generate(self, A) -> Factorization:
        data, device = matrix_data_and_device(A)
        d = data.canonical()
        n = d.shape[0]
        keep = d.row_idx >= d.col_idx
        lr = d.row_idx[keep].astype(np.int64)
        lc = d.col_idx[keep].astype(np.int64)
        lv0 = d.values[keep]
        # contribution pairs: for entry (i,j): (i,k) and (j,k), k<j
        import collections
        by_row = collections.defaultdict(dict)
        for idx, (i, k) in enumerate(zip(lr, lc)):
            by_row[i][k] = idx
        p1, p2, po = [], [], []
        for o, (i, j) in enumerate(zip(lr, lc)):
            rj = by_row[j]
            for k, idx_i in by_row[i].items():
                if k < j:
                    idx_j = rj.get(k)
                    if idx_j is not None:
                        p1.append(idx_i)
                        p2.append(idx_j)
                        po.append(o)
        diag_pos = np.full(n, 0, np.int64)
        for idx, (i, j) in enumerate(zip(lr, lc)):
            if i == j:
                diag_pos[i] = idx
        is_diag = lr == lc

        # scaled init (same divergence fix as ParIlu): l_jj = sqrt|a_jj|,
        # l_ij = a_ij / sqrt|a_jj|
        dj = np.sqrt(np.abs(lv0[diag_pos]))
        dj = np.where(dj == 0, np.ones_like(dj), dj)
        lv_init = np.where(is_diag, dj[lr],
                           lv0 / dj[lc]).astype(lv0.dtype)

        def put(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(
                a if dtype is None else np.asarray(a, dtype))).to(device)

        lv = _ic_sweeps_kernel(
            put(lv0), put(lv_init), put(p1, np.int64), put(p2, np.int64),
            put(po, np.int64), put(diag_pos), put(is_diag), put(lr),
            put(lc), int(self.iterations)).cpu().numpy()
        return _factor_pair(MatrixData((n, n), lr, lc, lv), device)


# ---------------------------------------------------------------------------
# Exact host reference — core/factorization/{ilu,ic}.cpp analog (oracle)
# ---------------------------------------------------------------------------

class Ilu0:
    """Exact ILU(0): IKJ elimination restricted to A's pattern.

    Primary path: native ``gt_ilu0`` (position-scatter IKJ on CSR —
    O(nnz · row) host time, millions of rows in seconds).  Fallback:
    the dict-based Python elimination (small matrices only)."""

    def generate(self, A) -> Factorization:
        data, device = matrix_data_and_device(A)
        d = data.canonical()
        n = d.shape[0]
        from ..native import ilu0_native
        ptr = np.searchsorted(d.row_idx, np.arange(n + 1)).astype(np.int64)
        dtype = d.values.dtype
        wide = (np.complex128 if np.iscomplexobj(d.values) else np.float64)
        # MUST copy: canonical() may alias the caller's arrays and gt_ilu0
        # factorizes IN PLACE
        vals = np.array(d.values, wide, copy=True)
        if ilu0_native(n, ptr, d.col_idx.astype(np.int64), vals):
            lo = d.col_idx < d.row_idx
            return _build_factors(
                n, d.row_idx[lo], d.col_idx[lo], vals[lo].astype(dtype),
                d.row_idx[~lo], d.col_idx[~lo], vals[~lo].astype(dtype),
                dtype, device)
        rows = [dict() for _ in range(n)]
        for i, j, v in zip(d.row_idx, d.col_idx, d.values):
            rows[int(i)][int(j)] = v
        for i in range(n):
            ri = rows[i]
            for k in sorted(c for c in ri if c < i):
                dk = rows[k].get(k, 0)
                if dk == 0:
                    continue
                ri[k] = lik = ri[k] / dk
                for j, ukj in rows[k].items():
                    if j > k and j in ri:
                        ri[j] -= lik * ukj
        lr, lc, lv, ur, uc, uv = [], [], [], [], [], []
        for i in range(n):
            for j, v in rows[i].items():
                if j < i:
                    lr.append(i)
                    lc.append(j)
                    lv.append(v)
                else:
                    ur.append(i)
                    uc.append(j)
                    uv.append(v)
        return _build_factors(
            n, np.asarray(lr, np.int64), np.asarray(lc, np.int64),
            np.asarray(lv, dtype), np.asarray(ur, np.int64),
            np.asarray(uc, np.int64), np.asarray(uv, dtype), dtype, device)


class Ic0:
    """Exact IC(0): incomplete Cholesky on A's lower pattern.

    Primary path: native ``gt_ic0`` (up-looking pattern-restricted
    Cholesky with a position-scatter array).  The Python fallback's
    column loop is O(n^2) — toy sizes only."""

    def generate(self, A) -> Factorization:
        data, device = matrix_data_and_device(A)
        d = data.canonical()
        n = d.shape[0]
        from ..native import ic0_native
        lo_m = d.col_idx <= d.row_idx
        lr0 = d.row_idx[lo_m]
        lc0 = d.col_idx[lo_m]
        dtype = d.values.dtype
        wide = (np.complex128 if np.iscomplexobj(d.values) else np.float64)
        vals = np.ascontiguousarray(d.values[lo_m], wide)
        ptr = np.searchsorted(lr0, np.arange(n + 1)).astype(np.int64)
        if ic0_native(n, ptr, lc0.astype(np.int64), vals):
            return _factor_pair(
                MatrixData((n, n), lr0, lc0, vals.astype(dtype)), device)
        rows = [dict() for _ in range(n)]
        for i, j, v in zip(d.row_idx, d.col_idx, d.values):
            if j <= i:
                rows[int(i)][int(j)] = v
        for j in range(n):
            s = rows[j].get(j, 0)
            s -= sum(abs(v) ** 2 for k, v in rows[j].items() if k < j)
            ljj = np.sqrt(abs(s))
            rows[j][j] = ljj if ljj != 0 else 1.0
            for i in range(j + 1, n):
                if j in rows[i]:
                    s = rows[i][j]
                    for k, v in rows[i].items():
                        if k < j and k in rows[j]:
                            s -= v * np.conj(rows[j][k])
                    rows[i][j] = s / rows[j][j]
        lr, lc, lv = [], [], []
        for i in range(n):
            for j, v in rows[i].items():
                lr.append(i)
                lc.append(j)
                lv.append(v)
        l_data = MatrixData((n, n), np.asarray(lr, np.int64),
                            np.asarray(lc, np.int64), np.asarray(lv, dtype))
        return _factor_pair(l_data, device)
