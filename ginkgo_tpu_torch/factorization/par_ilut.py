"""ParILUT / ParICT — threshold-based incomplete factorization
(``ginkgo_tpu/factorization/par_ilut.py`` in torch).

Analog of ``core/factorization/par_ilut.cpp:262-350`` and
``par_ict.hpp:69``.  Three algorithms:

* ``packed`` (``par_ilut_packed.py``): the whole loop on the factor's
  device over a fixed slot universe, every product a pair contraction
  (kernel D on CUDA).  ``auto`` takes it on a CUDA device at n >= 16384,
  after the DIA path (``par_ilut_dia.py``) has declined.
* ``dia`` (``par_ilut_dia.py``): the whole loop on the factor's device
  over diagonal slabs of a fixed offset universe; ``auto`` tries it first
  on a CUDA device at n >= 16384, and it declines matrices that are not
  diagonal-structured.
* ``general``, the host path below.  Each outer iteration:

  1+2. product + add_candidates + seed, FUSED: one native pass
     (``gt_parilut_candidates``) accumulates each (I+L)@U row, merges it
     with A's row and emits the union with seed = one Jacobi Chow-Patel
     sweep evaluated at the current iterate (new entries start from the
     residual).  Candidates are written directly into reusable numpy
     buffers (capacity hint + exact retry).
  3. threshold_select: k-th smallest |value| so nnz shrinks back to
     ``fill_in_limit * nnz(ILU0 pattern)`` (numpy partition)
  4. threshold_filter: drop below-threshold entries (diagonal always kept)
  5. second sweep on the filtered pattern — ``sweep_mode='host'``: native
     row-major Gauss-Seidel (U^T built in-kernel); ``'device'``: the
     ParILU pair-list ``index_add_`` sweeps on the factor's device.

Where a device plan declines, ``auto`` continues on the host path, as the
reference does; a caller who named ``packed`` or ``dia`` on a CUDA device
gets ``NotSupportedError`` instead of factors made on the host.  The
factorization's ``route`` names the path taken.  Numpy fallbacks cover
every native call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.exceptions import NotSupportedError
from ..base.matrix_data import MatrixData
from ..device import matrix_data_and_device
from .container import Factorization
from .par_ilu import _build_factors, _factor_pair


def _sorted_lookup(keys_sorted, vals, query, default=0.0):
    """Vectorized map lookup: keys_sorted ascending unique int64."""
    if keys_sorted.size == 0:
        return np.full(query.shape, default,
                       vals.dtype if vals.size else np.float64)
    pos = np.searchsorted(keys_sorted, query)
    pos_c = np.minimum(pos, keys_sorted.size - 1)
    hit = keys_sorted[pos_c] == query
    out = np.where(hit, vals[pos_c], default)
    return out


def _lu_product(n, lr, lc, lv, ur, uc, uv, dtype):
    """(sorted keys, values) of (L + I) @ U, all in scipy C routines —
    no COO round-trip, no O(nnz log nnz) host argsort."""
    import scipy.sparse as sp
    diag = np.arange(n)
    L = sp.csr_matrix(
        (np.concatenate([lv, np.ones(n, dtype)]),
         (np.concatenate([lr, diag]), np.concatenate([lc, diag]))),
        shape=(n, n))
    U = sp.csr_matrix((uv, (ur, uc)), shape=(n, n))
    C = L @ U
    C.sum_duplicates()          # sorts indices -> globally ascending keys
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(C.indptr))
    return rows * n + C.indices, C.data


def _sweep_jacobi(n, lr, lc, lv, ur, uc, uv, la, ua, iterations):
    """Synchronous (Jacobi) Chow-Patel sweeps via the residual-
    correction identity: with unit-lower L and upper U, one sweep is

        l_ij <- l_ij + (A - L@U)_ij / u_jj      (i > j)
        u_ij <- u_ij + (A - L@U)_ij             (i <= j)

    because (L@U)_ij already contains the k = min(i, j) term
    (l_ij * u_jj resp. 1 * u_ij).  Each sweep costs one sparse product
    (host SMMP, O(flops)) + two sorted-key lookups.  Fallback only:
    the synchronous form can diverge where the reference's in-place
    (asynchronous) sweeps converge."""
    dtype = lv.dtype
    lkey = lr * n + lc          # queries need not be sorted
    ukey = ur * n + uc
    on_diag = ur == uc
    for _ in range(int(iterations)):
        lukey, luval = _lu_product(n, lr, lc, lv, ur, uc, uv, dtype)
        udiag = np.ones(n, dtype)
        udiag[ur[on_diag]] = uv[on_diag]
        udiag[udiag == 0] = 1.0
        r_l = la - _sorted_lookup(lukey, luval, lkey).astype(dtype)
        r_u = ua - _sorted_lookup(lukey, luval, ukey).astype(dtype)
        lv = lv + r_l / udiag[lc]
        uv = uv + r_u
    return lv, uv


def _csr_ptr(rows, n):
    return np.searchsorted(rows, np.arange(n + 1)).astype(np.int64)


def _rowmajor_perm(r, c, n):
    """Permutation making (r, c) row-major ascending, or None when the
    arrays already are (O(nnz) check; avoids materializing a 100MB+
    identity permutation on multi-million-entry patterns)."""
    key = r * n + c
    if key.size < 2 or (np.diff(key) > 0).all():
        return None
    return np.lexsort((c, r))


def _take(x, perm):
    return x if perm is None else x[perm]


def _sweep_device(n, lr, lc, lv, ur, uc, uv, la, ua, iterations, device):
    """Device pair-list Chow-Patel sweeps on an arbitrary split pattern:
    the ParILU gather-multiply-``index_add_`` sweeps
    (``par_ilu._sweeps_kernel``) with contribution pairs enumerated for
    THIS pattern, on ``device``.  Jacobi (synchronous) semantics.
    Returns (lv, uv) or None when pair enumeration is unavailable."""
    from ..native import ilu_pairs_native
    from .par_ilu import _sweeps_kernel
    lo = _rowmajor_perm(lr, lc, n)
    uo = _rowmajor_perm(ur, uc, n)
    lrs, lcs = _take(lr, lo), _take(lc, lo)
    urs, ucs = _take(ur, uo), _take(uc, uo)
    pairs = ilu_pairs_native(n, lrs, lcs, urs, ucs)
    if pairs is None:
        return None
    pl, pu, po = pairs
    on_diag = urs == ucs
    udiag_pos = np.full(n, 0, np.int64)
    udiag_pos[urs[on_diag]] = np.flatnonzero(on_diag)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    lvs, uvs = _sweeps_kernel(
        put(_take(lv, lo)), put(_take(uv, uo)), put(_take(la, lo)),
        put(_take(ua, uo)), put(pl), put(pu), put(po), put(lcs),
        put(udiag_pos), int(iterations))
    lv_out = lvs.cpu().numpy()
    uv_out = uvs.cpu().numpy()
    if lo is not None:
        tmp = np.empty_like(lv_out)
        tmp[lo] = lv_out
        lv_out = tmp
    if uo is not None:
        tmp = np.empty_like(uv_out)
        tmp[uo] = uv_out
        uv_out = tmp
    return lv_out, uv_out


def _sweep(n, lr, lc, lv, ur, uc, uv, la, ua, iterations,
           a_csr=None, mode="host", device="cpu"):
    """Run Chow-Patel sweeps on the given split pattern; returns values.

    ``mode='host'`` (default): the native C++ in-place Gauss-Seidel
    sweep — exact semantics of the reference's ``compute_l_u_factors``
    (``reference/factorization/par_ilut_kernels.cpp:239``), row-major
    sequential updates, which converge robustly.  ``mode='device'``:
    the pair-list ``index_add_`` sweeps on ``device`` (Jacobi semantics —
    the reference's GPU sweeps are likewise parallel with benign races);
    ``'auto'`` picks device when ``device`` is a CUDA device.  ``a_csr``
    is (a_ptr, a_cols, a_vals) of A; when None, it is reconstructed from
    ``la``/``ua`` (the A-values on the pattern, zeros where A has no
    entry — equivalent lookups).  Falls back to the Jacobi form when the
    native tier is unavailable."""
    if mode == "auto":
        mode = "device" if torch.device(device).type == "cuda" else "host"
    if mode == "device" and int(iterations) > 0 and len(lr) + len(ur):
        out = _sweep_device(n, lr, lc, lv, ur, uc, uv, la, ua, iterations,
                            device)
        if out is not None:
            return out
    from ..native import parilut_sweep_csr_native
    if int(iterations) <= 0 or len(lr) + len(ur) == 0:
        return lv, uv
    work_dtype = (np.complex128 if np.iscomplexobj(lv) else np.float64)

    # sort L and U row-major (usually already are — O(nnz) check);
    # the native kernel builds U^T in-kernel at memcpy speed
    lo = _rowmajor_perm(lr, lc, n)
    lrs, lcs = _take(lr, lo), _take(lc, lo)
    lvs = np.ascontiguousarray(_take(lv, lo), work_dtype)
    if lvs is lv:
        lvs = lv.astype(work_dtype, copy=True)   # kernel mutates in place
    uo = _rowmajor_perm(ur, uc, n)
    urs, ucs = _take(ur, uo), _take(uc, uo)
    uvs = np.ascontiguousarray(_take(uv, uo), work_dtype)
    if uvs is uv:
        uvs = uv.astype(work_dtype, copy=True)

    if a_csr is None:
        # A-on-pattern proxy: exact for the lookups the sweep performs
        ar = np.concatenate([lrs, urs])
        ac = np.concatenate([lcs, ucs])
        av = np.concatenate([_take(la, lo), _take(ua, uo)]).astype(
            work_dtype, copy=False)
        ao = np.lexsort((ac, ar))
        ar, ac, av = ar[ao], ac[ao], av[ao]
        a_ptr = _csr_ptr(ar, n)
        a_cols = np.ascontiguousarray(ac)
        a_vals = np.ascontiguousarray(av)
    else:
        a_ptr, a_cols, a_vals = a_csr
        a_vals = np.ascontiguousarray(a_vals, work_dtype)
        a_ptr = np.ascontiguousarray(a_ptr, dtype=np.int64)
        a_cols = np.ascontiguousarray(a_cols, dtype=np.int64)

    ok = parilut_sweep_csr_native(
        n, a_ptr, a_cols, a_vals, _csr_ptr(lrs, n),
        np.ascontiguousarray(lcs, np.int64), lvs, _csr_ptr(urs, n),
        np.ascontiguousarray(ucs, np.int64), uvs, iterations)
    if ok is None:
        return _sweep_jacobi(n, lr, lc, lv, ur, uc, uv, la, ua,
                             iterations)
    dtype = lv.dtype
    if lo is None:
        lv_out = lvs.astype(dtype, copy=False)
    else:
        lv_out = np.empty_like(lv)
        lv_out[lo] = lvs.astype(dtype, copy=False)
    if uo is None:
        uv_out = uvs.astype(dtype, copy=False)
    else:
        uv_out = np.empty_like(uv)
        uv_out[uo] = uvs.astype(dtype, copy=False)
    return lv_out, uv_out


def _threshold_select(r, c, v, keep_count, keep_diag=True):
    """Ascending indices of the ``keep_count`` largest-|v| entries
    (+ the diagonal) — threshold_select + threshold_filter analog."""
    if v.shape[0] <= keep_count:
        return np.arange(v.shape[0])
    mag = np.abs(v).astype(np.float64, copy=False)
    if keep_diag:
        mag = mag.copy()
        mag[r == c] = np.inf
    # k-th largest threshold (threshold_select analog)
    order = np.argpartition(-mag, keep_count - 1)[:keep_count]
    return np.sort(order)


def _device_route(algorithm, device, n):
    """(try dia, try packed): the reference's routing with "accel" read
    as "the factor's device is CUDA"; ``auto`` takes the device paths
    only from 16384 rows (below that the host path finishes first)."""
    auto = algorithm == "auto" and torch.device(device).type == "cuda" \
        and n >= 16384
    return algorithm == "dia" or auto, algorithm == "packed" or auto


def _declined(factory, algorithm, device, path):
    """The ``path`` plan declined the matrix.  ``auto`` goes on to the next
    path; a caller who named ``path`` on a CUDA device gets an error, since
    the host path would move the work to the CPU unseen."""
    if algorithm == path and torch.device(device).type == "cuda":
        raise NotSupportedError(
            f"{factory}(algorithm={path!r}): the {path} plan declines this "
            f"matrix; algorithm='auto' or 'general' takes the host path")


def _routed(F, route):
    F.route = route
    return F


class ParIlut:
    """Factory (par_ilut.hpp:72 params): ``iterations``, ``fill_in_limit``.

    The factors land on A's device (a port operator's, else the default
    device)."""

    def __init__(self, iterations: int = 5, fill_in_limit: float = 2.0,
                 sweeps_per_iteration: int = 1, sweep_mode: str = "host",
                 algorithm: str = "auto"):
        if sweep_mode not in ("host", "device", "auto"):
            raise ValueError(f"unknown sweep_mode {sweep_mode!r}")
        if algorithm not in ("auto", "dia", "packed", "general"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.iterations = iterations
        self.fill_in_limit = fill_in_limit
        self.sweeps = sweeps_per_iteration
        self.sweep_mode = sweep_mode
        self.algorithm = algorithm

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> Factorization:
        data, device = matrix_data_and_device(A)
        d = data.canonical()
        n = d.shape[0]
        dtype = d.values.dtype

        try_dia, try_packed = _device_route(self.algorithm, device, n)
        # device-resident DIA path for diagonal-structured matrices
        # (par_ilut_dia.py); declines unstructured matrices
        if try_dia:
            from .par_ilut_dia import generate_dia
            out = generate_dia(d, self.iterations, self.fill_in_limit,
                               self.sweeps, device=device)
            if out is not None:
                lr, lc, lv, ur, uc, uv = out
                return _routed(_build_factors(
                    n, lr, lc, lv.astype(dtype), ur, uc, uv.astype(dtype),
                    dtype, device), "dia")
            _declined("ParIlut", self.algorithm, device, "dia")
        # device-resident packed path for unstructured banded patterns
        # (FEM/graph, RCM'd): fixed slot universe + the pair-contraction
        # kernel — see par_ilut_packed.py
        if try_packed:
            from .par_ilut_packed import generate_packed
            # Jacobi device sweeps converge at ~half the host GS rate
            # (Chow & Patel); two per iteration track the host factor
            # quality at one extra cheap device product each
            out = generate_packed(d, self.iterations, self.fill_in_limit,
                                  max(self.sweeps, 2), device=device)
            if out is not None:
                lr, lc, lv, ur, uc, uv = out
                return _routed(_build_factors(
                    n, lr, lc, lv.astype(dtype), ur, uc, uv.astype(dtype),
                    dtype, device), "packed")
            _declined("ParIlut", self.algorithm, device, "packed")
        # canonical order == ascending (row, col) keys: a sorted map
        akey = d.row_idx.astype(np.int64) * n + d.col_idx
        aval = d.values

        def a_at(r, c):
            return _sorted_lookup(akey, aval, r * n + c).astype(dtype)

        a_csr = (_csr_ptr(d.row_idx.astype(np.int64), n),
                 d.col_idx.astype(np.int64), d.values)

        # initial split on A's pattern (ILU0 pattern), ParILU init values
        from .par_ilu import _split_pattern
        _, (lr, lc), (ur, uc) = _split_pattern(d)
        lv = a_at(lr, lc)
        uv = a_at(ur, uc)
        lv, uv = _sweep(n, lr, lc, lv, ur, uc, uv, lv.copy(), uv.copy(), 3,
                        a_csr=a_csr, mode=self.sweep_mode, device=device)
        nnz_l0, nnz_u0 = len(lr), len(ur)
        keep_l = int(np.ceil(self.fill_in_limit * nnz_l0))
        keep_u = int(np.ceil(self.fill_in_limit * nnz_u0))

        from ..native import parilut_candidates_native
        scratch = {}
        for _ in range(self.iterations):
            # 1+2. fused product + add_candidates + Jacobi seed
            # (par_ilut.cpp:262): ONE native pass over the (I+L)@U row
            # merges (gt_parilut_candidates)
            lo = _rowmajor_perm(lr, lc, n)
            uo = _rowmajor_perm(ur, uc, n)
            nat = parilut_candidates_native(
                n, a_csr[0], a_csr[1], a_csr[2],
                _csr_ptr(_take(lr, lo), n), _take(lc, lo), _take(lv, lo),
                _csr_ptr(_take(ur, uo), n), _take(uc, uo), _take(uv, uo),
                scratch=scratch)
            if nat is not None:
                ci, cj, seed, a_c = nat
                low = ci > cj
                lr2, lc2 = ci[low], cj[low]
                lv2 = seed[low].astype(dtype, copy=False)
                ur2, uc2 = ci[~low], cj[~low]
                uv2 = seed[~low].astype(dtype, copy=False)
                a_low = a_c[low].astype(dtype, copy=False)
                a_up = a_c[~low].astype(dtype, copy=False)
            else:
                # numpy fallback: scipy product + sorted-key merges
                lukey, luval = _lu_product(n, lr, lc, lv, ur, uc, uv,
                                           dtype)
                cand = np.union1d(akey, lukey)
                ci = cand // n
                cj = cand % n
                a_c = np.zeros(cand.size, dtype)
                a_c[np.searchsorted(cand, akey)] = aval
                r_c = a_c - _sorted_lookup(lukey, luval,
                                           cand).astype(dtype, copy=False)
                udiag = np.ones(n, dtype)
                on_diag = ur == uc
                udiag[ur[on_diag]] = uv[on_diag]
                udiag[udiag == 0] = 1.0

                # The seed IS one Jacobi Chow-Patel sweep over the
                # enlarged pattern evaluated at the current iterate (new
                # entries have old value 0): l + (A - LU)_ij/u_jj resp.
                # u + (A - LU)_ij.
                old_c = np.zeros(cand.size, dtype)
                old_c[np.searchsorted(cand, lr * n + lc)] = lv
                old_c[np.searchsorted(cand, ur * n + uc)] = uv
                low = ci > cj
                lr2, lc2 = ci[low], cj[low]
                lv2 = old_c[low] + r_c[low] / udiag[cj[low]]
                ur2, uc2 = ci[~low], cj[~low]
                uv2 = old_c[~low] + r_c[~low]
                a_low = a_c[low]
                a_up = a_c[~low]

            # 4+5. select + filter back to the fill budget
            lkeep = _threshold_select(lr2, lc2, lv2, keep_l,
                                      keep_diag=False)
            ukeep = _threshold_select(ur2, uc2, uv2, keep_u,
                                      keep_diag=True)
            lr, lc, lv = lr2[lkeep], lc2[lkeep], lv2[lkeep]
            ur, uc, uv = ur2[ukeep], uc2[ukeep], uv2[ukeep]

            # 6. second sweep on the filtered pattern (A values ride
            # along from the candidate array — no fresh lookups)
            lv, uv = _sweep(n, lr, lc, lv, ur, uc, uv, a_low[lkeep],
                            a_up[ukeep], self.sweeps, a_csr=a_csr,
                            mode=self.sweep_mode, device=device)

        return _routed(_build_factors(n, lr, lc, lv, ur, uc, uv, dtype,
                                      device), "general")


def _ict_sweep(n, lr, lc, lv, a_ptr, a_cols, a_vals, iterations):
    """IC(T) Gauss-Seidel sweeps on a lower pattern (row-major sorted,
    diag last per row): native kernel with a Python fallback."""
    from ..native import parict_sweep_native
    work_dtype = np.complex128 if np.iscomplexobj(lv) else np.float64
    l_ptr = _csr_ptr(lr, n)
    lvs = np.ascontiguousarray(lv.astype(work_dtype))
    ok = parict_sweep_native(
        n, np.ascontiguousarray(a_ptr, np.int64),
        np.ascontiguousarray(a_cols, np.int64),
        np.ascontiguousarray(a_vals.astype(work_dtype)), l_ptr,
        np.ascontiguousarray(lc, np.int64), lvs, iterations)
    if ok is None:
        # sequential Python fallback (small problems / no toolchain):
        # the same in-place row-major GS recurrence
        a_cols = np.asarray(a_cols)
        a_vals_w = np.asarray(a_vals, work_dtype)
        lc_np = np.asarray(lc)
        rows = [dict() for _ in range(n)]
        for p in range(len(lr)):
            rows[int(lr[p])][int(lc_np[p])] = p

        def a_at(i, j):
            lo, hi = a_ptr[i], a_ptr[i + 1]
            pos = lo + np.searchsorted(a_cols[lo:hi], j)
            if pos < hi and a_cols[pos] == j:
                return a_vals_w[pos]
            return 0.0

        for _ in range(int(iterations)):
            for i in range(n):
                for p in range(l_ptr[i], l_ptr[i + 1]):
                    j = int(lc_np[p])
                    s = a_at(i, j)
                    for k, pik in rows[i].items():
                        if k < j and k in rows[j]:
                            s -= lvs[pik] * np.conj(lvs[rows[j][k]])
                    if j == i:
                        mag = np.sqrt(abs(s))
                        if np.isfinite(mag) and mag != 0:
                            lvs[p] = mag
                    else:
                        djj = lvs[l_ptr[j + 1] - 1]
                        nv = s / djj
                        if np.isfinite(nv):
                            lvs[p] = nv
    return lvs.astype(lv.dtype)


class ParIct:
    """Threshold incomplete Cholesky — the real ParICT
    (``core/factorization/par_ict.cpp``, ``par_ict.hpp:69``): candidate
    pattern tril(pattern(A) ∪ pattern(L@Lᴴ)), residual-seeded new
    entries, in-place Gauss-Seidel IC sweeps (native
    ``gt_parict_sweep``), threshold select/filter back to
    ``fill_in_limit * nnz(tril(A))``, final sweep.  U = Lᴴ."""

    def __init__(self, iterations: int = 5, fill_in_limit: float = 2.0,
                 algorithm: str = "auto"):
        if algorithm not in ("auto", "dia", "packed", "general"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.iterations = iterations
        self.fill_in_limit = fill_in_limit
        self.algorithm = algorithm

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> Factorization:
        import scipy.sparse as sp
        data, device = matrix_data_and_device(A)
        d = data.canonical()
        n = d.shape[0]
        dtype = d.values.dtype

        def _sym_factors(lr, lc, lv):
            return _factor_pair(MatrixData((n, n), lr, lc, lv.astype(dtype)),
                                device)

        try_dia, try_packed = _device_route(self.algorithm, device, n)
        # device-resident DIA path (see par_ilut_dia.generate_dia_ict)
        if try_dia:
            from .par_ilut_dia import generate_dia_ict
            out = generate_dia_ict(d, self.iterations, self.fill_in_limit,
                                   device=device)
            if out is not None:
                return _routed(_sym_factors(*out), "dia")
            _declined("ParIct", self.algorithm, device, "dia")
        # packed path for unstructured banded patterns
        if try_packed:
            from .par_ilut_packed import generate_packed_ict
            out = generate_packed_ict(d, self.iterations, self.fill_in_limit,
                                      device=device)
            if out is not None:
                return _routed(_sym_factors(*out), "packed")
            _declined("ParIct", self.algorithm, device, "packed")
        low = d.row_idx >= d.col_idx
        lr = d.row_idx[low].astype(np.int64)
        lc = d.col_idx[low].astype(np.int64)
        lv = d.values[low].copy()
        # ensure a full diagonal
        have = np.zeros(n, bool)
        have[lr[lr == lc]] = True
        missing = np.flatnonzero(~have)
        if missing.size:
            lr = np.concatenate([lr, missing])
            lc = np.concatenate([lc, missing])
            lv = np.concatenate([lv, np.zeros(missing.size, dtype)])
            o = np.lexsort((lc, lr))
            lr, lc, lv = lr[o], lc[o], lv[o]
        # A's lower CSR for the a(i, j) lookups
        a_ptr = _csr_ptr(lr, n)
        a_cols = lc.copy()
        a_vals = lv.copy()
        akey = lr * n + lc

        def a_at(q):
            return _sorted_lookup(akey, a_vals, q).astype(dtype)

        # init: scaled first guess, then sweeps on A's lower pattern
        diag0 = np.sqrt(np.abs(a_at(np.arange(n) * n + np.arange(n))))
        diag0[diag0 == 0] = 1.0
        lv = np.where(lr == lc, diag0[lr].astype(dtype),
                      (lv / diag0[lc]).astype(dtype))
        lv = _ict_sweep(n, lr, lc, lv, a_ptr, a_cols, a_vals, 3)
        keep_n = int(np.ceil(self.fill_in_limit * len(lr)))

        from ..native import parict_candidates_native
        for _ in range(self.iterations):
            # 1-3. fused product + add_candidates + one Jacobi-IC sweep
            # on the enlarged pattern (gt_parict_candidates)
            nat = parict_candidates_native(
                n, a_ptr, a_cols, a_vals, _csr_ptr(lr, n), lc, lv)
            if nat is not None:
                lr2, lc2, seed, _ = nat
                lv2 = seed.astype(dtype)
            else:
                # numpy fallback: scipy product + sorted-key merges,
                # then a GS sweep on the enlarged pattern
                Ls = sp.csr_matrix((lv, (lr, lc)), shape=(n, n))
                C = sp.tril(Ls @ Ls.conj().T).tocsr()
                C.sum_duplicates()
                crows = np.repeat(np.arange(n, dtype=np.int64),
                                  np.diff(C.indptr))
                ckey = crows * n + C.indices
                cand = np.union1d(akey, ckey)
                lkey = lr * n + lc
                old = np.zeros(cand.size, dtype)
                old[np.searchsorted(cand, lkey)] = lv
                isold = np.zeros(cand.size, bool)
                isold[np.searchsorted(cand, lkey)] = True
                r_c = (a_at(cand)
                       - _sorted_lookup(ckey, C.data, cand).astype(dtype))
                dl = np.ones(n, dtype)
                dl[lr[lr == lc]] = lv[lr == lc]
                dl[dl == 0] = 1.0
                ci, cj = cand // n, cand % n
                lv2 = np.where(isold, old, (r_c / dl[cj]).astype(dtype))
                lr2, lc2 = ci, cj
                lv2 = _ict_sweep(n, lr2, lc2, lv2, a_ptr, a_cols, a_vals,
                                 1)
            # 4+5. select + filter
            keep = _threshold_select(lr2, lc2, lv2, keep_n,
                                     keep_diag=True)
            lr, lc, lv = lr2[keep], lc2[keep], lv2[keep]
            # 6. sweep on the filtered pattern
            lv = _ict_sweep(n, lr, lc, lv, a_ptr, a_cols, a_vals, 1)

        return _routed(_factor_pair(MatrixData((n, n), lr, lc, lv), device),
                       "general")
