"""Native C++ host tier (ctypes-loaded, numpy fallback everywhere).

The port's own copy of ``src/ginkgo_native.cpp`` (the C++ source of the JAX
package's host tier, unchanged), compiled on first use with
``g++ -O3 -march=native`` into ``lib/libginkgo_native.so`` beside this
file.  ``lib()`` returns the loaded library or None when no toolchain is
available: callers treat it as an accelerator, never a requirement, and
their numpy fallbacks give the same result.

Only the entry points the ported modules call are bound: the Matrix
Market reader (``base/mtx_io.py``), dependency levels (triangular
solves), ILU pair lists (ParILU), exact ILU(0)/IC(0), the COO
canonicalizer (``MatrixData.sum_duplicates``), for ParILUT/ParICT the
row-major pair emitters, the packed pair-contraction planner, the fused
candidate passes and the Gauss-Seidel sweeps, the streaming SpGEMM and
its pair unique (``ops/spgemm.py``), sparse LU and Cholesky with fill
(``factorization/direct.py``), the AMD, nested-dissection and MC64
orderings (``reorder/``) and the ISAI block fill and pair list
(``preconditioner/isai.py``).  ``gt_parilut_sweep`` (column-major U
sweeps) has no caller in either package and is left unbound.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "ginkgo_native.cpp")
_LIBDIR = os.path.join(_HERE, "lib")
_LIBPATH = os.path.join(_LIBDIR, "libginkgo_native.so")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """Compile to a temp path and atomically rename: concurrent builds
    (parallel pytest workers) or a timed-out g++ never leave a corrupt .so
    behind with a fresh mtime."""
    os.makedirs(_LIBDIR, exist_ok=True)
    tmp = f"{_LIBPATH}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, _SRC, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=240)
        if res.returncode != 0:
            return False
        os.replace(tmp, _LIBPATH)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _bind(lib):
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.gt_mtx_header.restype = ctypes.c_int
    lib.gt_mtx_header.argtypes = [ctypes.c_char_p, i64p, i64p, i64p, i32p,
                                  i32p, i32p, i32p]
    lib.gt_mtx_read_coord.restype = ctypes.c_int
    lib.gt_mtx_read_coord.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int32, ctypes.c_int32,
                                      i64p, i64p, f64p]
    lib.gt_compute_levels.restype = ctypes.c_int
    lib.gt_compute_levels.argtypes = [ctypes.c_int64, i64p, i64p,
                                      ctypes.c_int32, i64p]
    lib.gt_ilu_pairs_count.restype = ctypes.c_int64
    lib.gt_ilu_pairs_count.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p,
                                       i64p, ctypes.c_int64, i64p, i64p]
    lib.gt_ilu_pairs_fill.restype = ctypes.c_int64
    lib.gt_ilu_pairs_fill.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p,
                                      i64p, ctypes.c_int64, i64p, i64p,
                                      i64p, i64p, i64p]
    lib.gt_coo_canonicalize.restype = ctypes.c_int64
    lib.gt_coo_canonicalize.argtypes = [ctypes.c_int64, i64p, i64p, f64p,
                                        ctypes.c_int32]
    lib.gt_ilu0.restype = ctypes.c_int
    lib.gt_ilu0.argtypes = [ctypes.c_int64, i64p, i64p, f64p,
                            ctypes.c_int32]
    lib.gt_ic0.restype = ctypes.c_int
    lib.gt_ic0.argtypes = [ctypes.c_int64, i64p, i64p, f64p,
                           ctypes.c_int32]
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.gt_ilut_pairs_rowmajor_count.restype = ctypes.c_int64
    lib.gt_ilut_pairs_rowmajor_count.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i64p, ctypes.c_int64, i64p,
        i64p, ctypes.c_int64]
    lib.gt_ilut_pairs_rowmajor_fill.restype = ctypes.c_int64
    lib.gt_ilut_pairs_rowmajor_fill.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i64p, ctypes.c_int64, i64p,
        i64p, i32p, i32p, i32p, ctypes.c_int64]
    lib.gt_pair_plan_build.restype = ctypes.c_int
    lib.gt_pair_plan_build.argtypes = [
        ctypes.c_int64, i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        i64p]
    lib.gt_pair_plan_fetch.restype = ctypes.c_int
    lib.gt_pair_plan_fetch.argtypes = [i16p, i16p, i16p, i16p, i16p, i32p,
                                       i32p, i32p, i32p, i32p, i32p, i32p,
                                       i32p]
    lib.gt_ict_pairs_rowmajor_count.restype = ctypes.c_int64
    lib.gt_ict_pairs_rowmajor_count.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i64p, ctypes.c_int64]
    lib.gt_ict_pairs_rowmajor_fill.restype = ctypes.c_int64
    lib.gt_ict_pairs_rowmajor_fill.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i64p, i32p, i32p, i32p,
        ctypes.c_int64]
    lib.gt_parict_sweep.restype = ctypes.c_int
    lib.gt_parict_sweep.argtypes = [ctypes.c_int64, i64p, i64p, f64p,
                                    i64p, i64p, f64p, ctypes.c_int64,
                                    ctypes.c_int32]
    lib.gt_parilut_candidates.restype = ctypes.c_int64
    lib.gt_parilut_candidates.argtypes = [ctypes.c_int64, i64p, i64p, f64p,
                                          i64p, i64p, f64p, i64p, i64p,
                                          f64p, ctypes.c_int64, i64p, i64p,
                                          f64p, f64p, ctypes.c_int32]
    lib.gt_parict_candidates.restype = ctypes.c_int64
    lib.gt_parict_candidates.argtypes = [ctypes.c_int64, i64p, i64p, f64p,
                                         i64p, i64p, f64p, ctypes.c_int64,
                                         i64p, i64p, f64p, f64p,
                                         ctypes.c_int32]
    lib.gt_parilut_sweep_csr.restype = ctypes.c_int
    lib.gt_parilut_sweep_csr.argtypes = [ctypes.c_int64, i64p, i64p, f64p,
                                         i64p, i64p, f64p, i64p, i64p,
                                         f64p, ctypes.c_int64,
                                         ctypes.c_int32]
    lib.gt_spgemm_count.restype = ctypes.c_int64
    lib.gt_spgemm_count.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p,
                                    i64p, i64p, i64p]
    lib.gt_spgemm_fill.restype = ctypes.c_int64
    lib.gt_spgemm_fill.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p,
                                   i64p, f64p, i64p, i64p, f64p, i64p,
                                   i64p, f64p, ctypes.c_int32]
    lib.gt_pairs_unique.restype = ctypes.c_int64
    lib.gt_pairs_unique.argtypes = [ctypes.c_int64, i64p, i64p, i64p,
                                    ctypes.c_int64, i64p, i64p]
    lib.gt_mc64_match.restype = ctypes.c_int
    lib.gt_mc64_match.argtypes = [ctypes.c_int64, i64p, i64p, f64p, f64p,
                                  i64p, i64p, i64p, ctypes.c_double]
    lib.gt_amd_order.restype = ctypes.c_int
    lib.gt_amd_order.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.gt_nd_order.restype = ctypes.c_int
    lib.gt_nd_order.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.gt_lu_factor.restype = ctypes.c_int64
    lib.gt_lu_factor.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p,
                                 i64p, f64p, ctypes.c_int32, i64p, i64p]
    lib.gt_chol_factor.restype = ctypes.c_int64
    lib.gt_chol_factor.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p,
                                   i64p, f64p, ctypes.c_int32]
    lib.gt_factor_fetch.restype = ctypes.c_int
    lib.gt_factor_fetch.argtypes = [ctypes.c_int32, i64p, i64p, f64p,
                                    ctypes.c_int32]
    lib.gt_isai_fill.restype = ctypes.c_int
    lib.gt_isai_fill.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p,
                                 i64p, f64p, i64p, i64p, f64p, f64p,
                                 ctypes.c_int32]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.gt_isai_pairs_count.restype = ctypes.c_int64
    lib.gt_isai_pairs_count.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                        i64p, i64p, i64p, i64p]
    lib.gt_isai_pairs_fill.restype = ctypes.c_int64
    lib.gt_isai_pairs_fill.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                       i64p, i64p, i64p, i64p, i64p,
                                       i64p, u8p, ctypes.c_int64]
    return lib


def lib():
    """The loaded native library, building it on first call; None if
    unavailable (callers fall back to numpy)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_LIBPATH) or (
                    os.path.getmtime(_LIBPATH) < os.path.getmtime(_SRC)):
                if not _build():
                    return None
            _lib = _bind(ctypes.CDLL(_LIBPATH))
        except OSError:
            # corrupt artifact: drop it so the next process rebuilds
            # instead of failing forever
            try:
                os.remove(_LIBPATH)
            except OSError:
                pass
            _lib = None
    return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_mtx_native(path: str):
    """(shape, rows, cols, vals, symmetry) of a coordinate Matrix Market
    file, or None (no library, no such file, or the ``array`` format:
    the caller reads those in Python)."""
    L = lib()
    if L is None or not os.path.exists(path):
        return None
    nr = ctypes.c_int64()
    nc = ctypes.c_int64()
    nnz = ctypes.c_int64()
    cpx = ctypes.c_int32()
    pat = ctypes.c_int32()
    sym = ctypes.c_int32()
    coord = ctypes.c_int32()
    rc = L.gt_mtx_header(path.encode(), ctypes.byref(nr), ctypes.byref(nc),
                         ctypes.byref(nnz), ctypes.byref(cpx),
                         ctypes.byref(pat), ctypes.byref(sym),
                         ctypes.byref(coord))
    if rc != 0:
        raise ValueError(f"invalid MatrixMarket header in {path!r} "
                         f"(native rc={rc})")
    if not coord.value:
        return None   # array format -> python path
    n = nnz.value
    rows = np.empty(n, np.int64)
    cols = np.empty(n, np.int64)
    vals = np.empty(2 * n if cpx.value else n, np.float64)
    rc = L.gt_mtx_read_coord(path.encode(), n, cpx.value, pat.value,
                             _ptr(rows, ctypes.c_int64),
                             _ptr(cols, ctypes.c_int64),
                             _ptr(vals, ctypes.c_double))
    if rc != 0:
        reason = {-6: "truncated body", -7: "malformed entry line",
                  -8: "index outside declared dimensions"}.get(
            rc, f"native rc={rc}")
        raise ValueError(f"invalid MatrixMarket body in {path!r}: {reason}")
    if cpx.value:
        vals = vals.view(np.complex128)
    return ((nr.value, nc.value), rows, cols, vals,
            {0: "general", 1: "symmetric", 2: "hermitian",
             3: "skew-symmetric"}[sym.value])


def compute_levels_native(n, ptr, cols, lower: bool):
    L = lib()
    if L is None:
        return None
    ptr = np.ascontiguousarray(ptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    level = np.zeros(n, np.int64)
    L.gt_compute_levels(n, _ptr(ptr, ctypes.c_int64),
                        _ptr(cols, ctypes.c_int64), int(lower),
                        _ptr(level, ctypes.c_int64))
    return level


def ilu_pairs_native(n, lr, lc, ur, uc):
    L = lib()
    if L is None:
        return None
    lr = np.ascontiguousarray(lr, np.int64)
    lc = np.ascontiguousarray(lc, np.int64)
    ur = np.ascontiguousarray(ur, np.int64)
    uc = np.ascontiguousarray(uc, np.int64)
    count = L.gt_ilu_pairs_count(
        n, len(lr), _ptr(lr, ctypes.c_int64), _ptr(lc, ctypes.c_int64),
        len(ur), _ptr(ur, ctypes.c_int64), _ptr(uc, ctypes.c_int64))
    out_l = np.empty(count, np.int64)
    out_u = np.empty(count, np.int64)
    out_o = np.empty(count, np.int64)
    L.gt_ilu_pairs_fill(
        n, len(lr), _ptr(lr, ctypes.c_int64), _ptr(lc, ctypes.c_int64),
        len(ur), _ptr(ur, ctypes.c_int64), _ptr(uc, ctypes.c_int64),
        _ptr(out_l, ctypes.c_int64), _ptr(out_u, ctypes.c_int64),
        _ptr(out_o, ctypes.c_int64))
    return out_l, out_u, out_o


def ilu0_native(n, ptr, cols, vals):
    """Exact ILU(0) on the CSR pattern (values updated IN PLACE; f64 or
    c128 contiguous). Returns True, or None when native is unavailable."""
    L = lib()
    if L is None:
        return None
    is_cpx = np.iscomplexobj(vals)
    rc = L.gt_ilu0(n, _ptr(ptr, ctypes.c_int64),
                   _ptr(cols, ctypes.c_int64),
                   vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                   1 if is_cpx else 0)
    return rc == 0 or None


def ic0_native(n, ptr, cols, vals):
    """Exact IC(0) on the lower CSR pattern (values -> L in place)."""
    L = lib()
    if L is None:
        return None
    is_cpx = np.iscomplexobj(vals)
    rc = L.gt_ic0(n, _ptr(ptr, ctypes.c_int64),
                  _ptr(cols, ctypes.c_int64),
                  vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                  1 if is_cpx else 0)
    return rc == 0 or None


def coo_canonicalize_native(rows, cols, vals):
    """Sorted+deduplicated copies, or None."""
    L = lib()
    if L is None:
        return None
    is_cpx = np.iscomplexobj(vals)
    rows = np.ascontiguousarray(rows, np.int64).copy()
    cols = np.ascontiguousarray(cols, np.int64).copy()
    vals = np.ascontiguousarray(
        vals, np.complex128 if is_cpx else np.float64).copy()
    out = L.gt_coo_canonicalize(
        len(rows), _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
        vals.view(np.float64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)), int(is_cpx))
    return rows[:out], cols[:out], vals[:out]


def ilut_pairs_rowmajor_native(n, lr, lc, ur, uc, cap):
    """(pl, pu, po) int32 pairs of the restricted product (I+L)@U over the
    row-major-sorted slot universe, sorted by (po, pu) — the canonical
    order the packed-layout planner consumes (see ginkgo_native.cpp
    ilut_pairs_rowmajor_impl).  None when over ``cap`` or the library is
    unavailable."""
    L = lib()
    if L is None:
        return None
    lr = np.ascontiguousarray(lr, np.int64)
    lc = np.ascontiguousarray(lc, np.int64)
    ur = np.ascontiguousarray(ur, np.int64)
    uc = np.ascontiguousarray(uc, np.int64)
    count = L.gt_ilut_pairs_rowmajor_count(
        n, len(lr), _ptr(lr, ctypes.c_int64), _ptr(lc, ctypes.c_int64),
        len(ur), _ptr(ur, ctypes.c_int64), _ptr(uc, ctypes.c_int64),
        int(cap))
    if count < 0:
        return None
    pl = np.empty(count, np.int32)
    pu = np.empty(count, np.int32)
    po = np.empty(count, np.int32)
    got = L.gt_ilut_pairs_rowmajor_fill(
        n, len(lr), _ptr(lr, ctypes.c_int64), _ptr(lc, ctypes.c_int64),
        len(ur), _ptr(ur, ctypes.c_int64), _ptr(uc, ctypes.c_int64),
        _ptr(pl, ctypes.c_int32), _ptr(pu, ctypes.c_int32),
        _ptr(po, ctypes.c_int32), int(cap))
    if got != count:
        return None
    return pl, pu, po


def pair_plan_native(pl, pu, po, n_out, nv_cap, win_rows_cap, max_tail,
                     sl=0, su=0):
    """Native packed pair-contraction planner (gt_pair_plan_build/fetch;
    one per-tile sort + two linear walks vs the numpy planner's ~10
    O(npairs) passes).  Requires ``po`` sorted ascending (the native
    emitters' order).  Returns the stream dict of
    ``ops.pair_contract.plan_pair_contract`` minus the static meta
    (caller derives it), ``"reject"`` when the plan budgets reject
    (identical to the numpy planner returning None), or None when the
    library is unavailable / ``po`` is unsorted (caller falls back to
    numpy)."""
    L = lib()
    if L is None:
        return None
    pl = np.ascontiguousarray(pl, np.int32)
    pu = np.ascontiguousarray(pu, np.int32)
    po = np.ascontiguousarray(po, np.int32)
    meta = np.zeros(5, np.int64)
    rc = L.gt_pair_plan_build(
        len(po), _ptr(pl, ctypes.c_int32), _ptr(pu, ctypes.c_int32),
        _ptr(po, ctypes.c_int32), int(n_out), int(nv_cap),
        int(win_rows_cap), float(max_tail), int(sl), int(su),
        _ptr(meta, ctypes.c_int64))
    if rc == -2:
        return None
    if rc != 0:
        return "reject"
    T, NV, WLr, WUr, n_tail = (int(x) for x in meta)
    pls = np.empty((T, NV, 1024), np.int16)
    pus = np.empty((T, NV, 1024), np.int16)
    pos = np.empty((T, NV, 1024), np.int16)
    pes = np.empty((T, NV, 1024), np.int16)
    pesp = np.empty((T, NV, 1024), np.int16)
    lq = np.empty((T, NV), np.int32)
    uq = np.empty((T, NV), np.int32)
    nv = np.empty(T, np.int32)
    lbase = np.empty(T, np.int32)
    ubase = np.empty(T, np.int32)
    tl = np.empty(n_tail, np.int32)
    tu = np.empty(n_tail, np.int32)
    to = np.empty(n_tail, np.int32)
    i32 = ctypes.c_int32
    rc = L.gt_pair_plan_fetch(
        _ptr(pls, ctypes.c_int16), _ptr(pus, ctypes.c_int16),
        _ptr(pos, ctypes.c_int16), _ptr(pes, ctypes.c_int16),
        _ptr(pesp, ctypes.c_int16),
        _ptr(lq, i32), _ptr(uq, i32),
        _ptr(nv, i32), _ptr(lbase, i32), _ptr(ubase, i32),
        _ptr(tl, i32), _ptr(tu, i32), _ptr(to, i32))
    if rc != 0:
        return None
    return dict(T=T, NV=NV, WLr=WLr, WUr=WUr, pls=pls, pus=pus, pos=pos,
                pes=pes, pesp=pesp, lq=lq, uq=uq, nv=nv, lbase=lbase,
                ubase=ubase, tail=(tl, tu, to))


def ict_pairs_rowmajor_native(n, lr, lc, cap):
    """(p1, p2, po) int32 pairs of tril(L L^H) over the row-major lower
    universe (diag included), k < col(po), sorted by (po, p2); p2 is the
    conjugated factor's slot.  None when unavailable or over ``cap``."""
    L = lib()
    if L is None:
        return None
    lr = np.ascontiguousarray(lr, np.int64)
    lc = np.ascontiguousarray(lc, np.int64)
    count = L.gt_ict_pairs_rowmajor_count(
        n, len(lr), _ptr(lr, ctypes.c_int64), _ptr(lc, ctypes.c_int64),
        int(cap))
    if count < 0:
        return None
    p1 = np.empty(count, np.int32)
    p2 = np.empty(count, np.int32)
    po = np.empty(count, np.int32)
    got = L.gt_ict_pairs_rowmajor_fill(
        n, len(lr), _ptr(lr, ctypes.c_int64), _ptr(lc, ctypes.c_int64),
        _ptr(p1, ctypes.c_int32), _ptr(p2, ctypes.c_int32),
        _ptr(po, ctypes.c_int32), int(cap))
    if got != count:
        return None
    return p1, p2, po


def parict_sweep_native(n, a_ptr, a_cols, a_vals, l_ptr, l_cols,
                        l_vals, iterations):
    """In-place Gauss-Seidel IC(T) sweeps on a lower-triangular CSR
    pattern (cols ascending, diag last per row).  l_vals modified in
    place (float64/complex128).  Returns True or None."""
    L = lib()
    if L is None:
        return None
    is_cpx = np.iscomplexobj(l_vals)

    def fp(a):
        assert a.flags.c_contiguous
        return _ptr(a.view(np.float64), ctypes.c_double)

    def ip(a):
        assert a.dtype == np.int64 and a.flags.c_contiguous
        return _ptr(a, ctypes.c_int64)

    L.gt_parict_sweep(n, ip(a_ptr), ip(a_cols), fp(a_vals), ip(l_ptr),
                      ip(l_cols), fp(l_vals), int(iterations),
                      int(is_cpx))
    return True


def _cand_alloc(count, is_cpx):
    wide = np.complex128 if is_cpx else np.float64
    return (np.empty(count, np.int64), np.empty(count, np.int64),
            np.empty(count, wide), np.empty(count, wide))


def parilut_candidates_native(n, a_ptr, a_cols, a_vals, l_ptr, l_cols,
                              l_vals, u_ptr, u_cols, u_vals,
                              scratch=None):
    """Fused ParILUT add_candidates + Jacobi seed: one pass over the
    (I+L)@U product merged with A, written DIRECTLY into numpy buffers.
    ``scratch`` (a dict the caller keeps across outer iterations) reuses
    the output buffers and remembers the last candidate count, so the
    common path is ONE kernel call with zero staging copies.  Returns
    (rows, cols, seed, a_val) row-major ascending — VIEWS into the
    scratch buffers, invalidated by the next call — or None."""
    L = lib()
    if L is None:
        return None
    is_cpx = np.iscomplexobj(a_vals)
    wide = np.complex128 if is_cpx else np.float64

    def prep(x, dt=np.int64):
        return np.ascontiguousarray(x, dt)

    av = prep(a_vals, wide)
    lv = prep(l_vals, wide)
    uv = prep(u_vals, wide)
    ap, ac = prep(a_ptr), prep(a_cols)
    lp, lcc = prep(l_ptr), prep(l_cols)
    up, ucc = prep(u_ptr), prep(u_cols)
    if scratch is None:
        scratch = {}
    cap = scratch.get("cap") or int(2.8 * max(len(a_cols), 1)) + n

    def run(cap):
        bufs = scratch.get("bufs")
        if bufs is None or bufs[0].shape[0] < cap or bufs[2].dtype != wide:
            bufs = _cand_alloc(cap, is_cpx)
            scratch["bufs"] = bufs
        r, c, seed, a = bufs
        cap = r.shape[0]
        tot = L.gt_parilut_candidates(
            n, _ptr(ap, ctypes.c_int64), _ptr(ac, ctypes.c_int64),
            _ptr(av.view(np.float64), ctypes.c_double),
            _ptr(lp, ctypes.c_int64), _ptr(lcc, ctypes.c_int64),
            _ptr(lv.view(np.float64), ctypes.c_double),
            _ptr(up, ctypes.c_int64), _ptr(ucc, ctypes.c_int64),
            _ptr(uv.view(np.float64), ctypes.c_double),
            cap, _ptr(r, ctypes.c_int64), _ptr(c, ctypes.c_int64),
            _ptr(seed.view(np.float64), ctypes.c_double),
            _ptr(a.view(np.float64), ctypes.c_double), int(is_cpx))
        return tot, cap, r, c, seed, a

    tot, cap, r, c, seed, a = run(cap)
    if tot < 0:
        return None
    if tot > cap:
        tot, cap, r, c, seed, a = run(int(tot * 1.1) + 64)
    scratch["cap"] = max(int(tot * 1.1) + 64, cap)
    return r[:tot], c[:tot], seed[:tot], a[:tot]


def parict_candidates_native(n, a_ptr, a_cols, a_vals, l_ptr, l_cols,
                             l_vals):
    """Fused ParICT add_candidates + Jacobi-IC seed over tril(L L^H)
    merged with tril(A).  Returns (rows, cols, seed, a_val) or None."""
    L = lib()
    if L is None:
        return None
    is_cpx = np.iscomplexobj(a_vals)
    wide = np.complex128 if is_cpx else np.float64

    def prep(x, dt=np.int64):
        return np.ascontiguousarray(x, dt)

    av = prep(a_vals, wide)
    lv = prep(l_vals, wide)
    ap, ac = prep(a_ptr), prep(a_cols)
    lp, lcc = prep(l_ptr), prep(l_cols)
    cap = int(2.8 * max(len(a_cols), 1)) + n

    def run(cap):
        r, c, seed, a = _cand_alloc(cap, is_cpx)
        tot = L.gt_parict_candidates(
            n, _ptr(ap, ctypes.c_int64), _ptr(ac, ctypes.c_int64),
            _ptr(av.view(np.float64), ctypes.c_double),
            _ptr(lp, ctypes.c_int64), _ptr(lcc, ctypes.c_int64),
            _ptr(lv.view(np.float64), ctypes.c_double),
            cap, _ptr(r, ctypes.c_int64), _ptr(c, ctypes.c_int64),
            _ptr(seed.view(np.float64), ctypes.c_double),
            _ptr(a.view(np.float64), ctypes.c_double), int(is_cpx))
        return tot, r, c, seed, a

    tot, r, c, seed, a = run(cap)
    if tot < 0:
        return None
    if tot > cap:
        tot, r, c, seed, a = run(tot)
    return r[:tot], c[:tot], seed[:tot], a[:tot]


def parilut_sweep_csr_native(n, a_ptr, a_cols, a_vals, l_ptr, l_cols,
                             l_vals, u_ptr, u_cols, u_vals, iterations):
    """Row-major GS Chow-Patel sweeps; U^T built in-kernel.  Updates
    l_vals/u_vals IN PLACE (contiguous f64/c128).  True or None."""
    L = lib()
    if L is None:
        return None
    is_cpx = np.iscomplexobj(l_vals)
    rc = L.gt_parilut_sweep_csr(
        n, _ptr(a_ptr, ctypes.c_int64), _ptr(a_cols, ctypes.c_int64),
        _ptr(a_vals.view(np.float64), ctypes.c_double),
        _ptr(l_ptr, ctypes.c_int64), _ptr(l_cols, ctypes.c_int64),
        _ptr(l_vals.view(np.float64), ctypes.c_double),
        _ptr(u_ptr, ctypes.c_int64), _ptr(u_cols, ctypes.c_int64),
        _ptr(u_vals.view(np.float64), ctypes.c_double),
        int(iterations), int(is_cpx))
    return rc == 0 or None


def spgemm_csr_native(n, m, a_ptr, a_cols, a_vals, b_ptr, b_cols, b_vals):
    """Streaming Gustavson C = A @ B on row-major CSR: O(ncols)
    workspace, O(nnz_C) output, never an O(flops) pair list (the
    reference's hash/heap merge equivalents,
    csr_kernels.template.cpp:1247-1290 / omp csr_kernels.cpp:457-520).
    Returns (c_ptr, c_cols, c_vals) sorted within rows, or None."""
    L = lib()
    if L is None:
        return None
    is_cpx = np.iscomplexobj(a_vals) or np.iscomplexobj(b_vals)
    work = np.complex128 if is_cpx else np.float64
    a_ptr = np.ascontiguousarray(a_ptr, np.int64)
    a_cols = np.ascontiguousarray(a_cols, np.int64)
    b_ptr = np.ascontiguousarray(b_ptr, np.int64)
    b_cols = np.ascontiguousarray(b_cols, np.int64)
    a_vals = np.ascontiguousarray(a_vals, work)
    b_vals = np.ascontiguousarray(b_vals, work)

    def fp(a):
        return _ptr(a.view(np.float64), ctypes.c_double)

    nnz = L.gt_spgemm_count(n, m, _ptr(a_ptr, ctypes.c_int64),
                            _ptr(a_cols, ctypes.c_int64),
                            _ptr(b_ptr, ctypes.c_int64),
                            _ptr(b_cols, ctypes.c_int64))
    c_ptr = np.zeros(n + 1, np.int64)
    c_cols = np.empty(nnz, np.int64)
    c_vals = np.empty(nnz, work)
    got = L.gt_spgemm_fill(n, m, _ptr(a_ptr, ctypes.c_int64),
                           _ptr(a_cols, ctypes.c_int64), fp(a_vals),
                           _ptr(b_ptr, ctypes.c_int64),
                           _ptr(b_cols, ctypes.c_int64), fp(b_vals),
                           _ptr(c_ptr, ctypes.c_int64),
                           _ptr(c_cols, ctypes.c_int64), fp(c_vals),
                           int(is_cpx))
    if got != nnz:
        return None
    return c_ptr, c_cols, c_vals


def pairs_unique_native(n, pair_ptr, pair_j, cap_hint=None):
    """Row-grouped unique of SpGEMM contribution pairs: returns
    (inv, rows, cols) — inv maps each pair to its slot in the row-major
    output pattern — without a global O(flops log flops) sort.  None
    when native is unavailable."""
    L = lib()
    if L is None:
        return None
    pair_ptr = np.ascontiguousarray(pair_ptr, np.int64)
    pair_j = np.ascontiguousarray(pair_j, np.int64)
    total = int(pair_ptr[-1])
    inv = np.empty(total, np.int64)
    cap = int(cap_hint) if cap_hint else min(total, 4 * total // 5 + 64)

    def run(cap):
        rows = np.empty(cap, np.int64)
        cols = np.empty(cap, np.int64)
        nnz_c = L.gt_pairs_unique(n, _ptr(pair_ptr, ctypes.c_int64),
                                  _ptr(pair_j, ctypes.c_int64),
                                  _ptr(inv, ctypes.c_int64), cap,
                                  _ptr(rows, ctypes.c_int64),
                                  _ptr(cols, ctypes.c_int64))
        return nnz_c, rows, cols

    nnz_c, rows, cols = run(cap)
    if nnz_c > cap:
        nnz_c, rows, cols = run(nnz_c)
    return inv, rows[:nnz_c], cols[:nnz_c]


def mc64_match_native(n, ptr, cols, c, u, tol):
    """Sparse shortest-augmenting-path assignment (MC64 core).
    Returns (ok, p, ip, midx, u) or None when unavailable.  ``u`` is
    updated to the final column dual potentials."""
    L = lib()
    if L is None:
        return None
    ptr = np.ascontiguousarray(ptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    c = np.ascontiguousarray(c, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    p = np.empty(n, np.int64)
    ip = np.empty(n, np.int64)
    midx = np.empty(n, np.int64)
    rc = L.gt_mc64_match(n, _ptr(ptr, ctypes.c_int64),
                         _ptr(cols, ctypes.c_int64),
                         _ptr(c, ctypes.c_double),
                         _ptr(u, ctypes.c_double),
                         _ptr(p, ctypes.c_int64),
                         _ptr(ip, ctypes.c_int64),
                         _ptr(midx, ctypes.c_int64), float(tol))
    return rc == 0, p, ip, midx, u


def _fetch_triplets(L, which, count, is_cpx):
    """Copy factor ``which`` (0: L, 1: U) of the last native
    factorization out of the library's staging buffers."""
    r = np.empty(count, np.int64)
    c = np.empty(count, np.int64)
    v = np.empty(count, np.complex128 if is_cpx else np.float64)
    L.gt_factor_fetch(which, _ptr(r, ctypes.c_int64),
                      _ptr(c, ctypes.c_int64),
                      _ptr(v.view(np.float64), ctypes.c_double),
                      int(is_cpx))
    return r, c, v


def lu_factor_native(n, rows, cols, vals):
    """Sparse LU with fill (no pivoting; IKJ order).  Returns
    ((lr, lc, lv) strict lower, (ur, uc, uv) upper incl diag) or None.
    Not thread-safe (process-global staging)."""
    L = lib()
    if L is None:
        return None
    is_cpx = np.iscomplexobj(vals)
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(
        vals, np.complex128 if is_cpx else np.float64)
    l_nnz = ctypes.c_int64()
    u_nnz = ctypes.c_int64()
    tot = L.gt_lu_factor(n, len(rows), _ptr(rows, ctypes.c_int64),
                         _ptr(cols, ctypes.c_int64),
                         _ptr(vals.view(np.float64), ctypes.c_double),
                         int(is_cpx), ctypes.byref(l_nnz),
                         ctypes.byref(u_nnz))
    if tot < 0:
        return None
    lt = _fetch_triplets(L, 0, l_nnz.value, is_cpx)
    ut = _fetch_triplets(L, 1, u_nnz.value, is_cpx)
    return lt, ut


def chol_factor_native(n, rows, cols, vals):
    """Sparse Cholesky with fill; returns (lr, lc, lv) or None."""
    L = lib()
    if L is None:
        return None
    is_cpx = np.iscomplexobj(vals)
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(
        vals, np.complex128 if is_cpx else np.float64)
    cnt = L.gt_chol_factor(n, len(rows), _ptr(rows, ctypes.c_int64),
                           _ptr(cols, ctypes.c_int64),
                           _ptr(vals.view(np.float64), ctypes.c_double),
                           int(is_cpx))
    if cnt < 0:
        return None
    return _fetch_triplets(L, 0, cnt, is_cpx)


def _order_native(fn, n, ptr, adj):
    ptr = np.ascontiguousarray(ptr, np.int64)
    adj = np.ascontiguousarray(adj, np.int64)
    perm = np.empty(max(n, 1), np.int64)
    rc = fn(n, _ptr(ptr, ctypes.c_int64), _ptr(adj, ctypes.c_int64),
            _ptr(perm, ctypes.c_int64))
    if rc != 0:
        return None
    return perm[:n]


def amd_order_native(n, ptr, adj):
    """Approximate minimum degree ordering (quotient graph), or None.
    ``ptr``/``adj`` describe the symmetrized pattern without diagonal."""
    L = lib()
    if L is None:
        return None
    return _order_native(L.gt_amd_order, n, ptr, adj)


def nd_order_native(n, ptr, adj):
    """Multilevel nested dissection ordering (heavy-edge coarsening +
    FM-refined vertex separators + AMD leaf blocks), or None.
    ``ptr``/``adj`` describe the symmetrized pattern without diagonal."""
    L = lib()
    if L is None:
        return None
    return _order_native(L.gt_nd_order, n, ptr, adj)


def isai_fill_native(S, a_ptr, a_cols, a_vals, p_ptr, p_cols, subs, rhs):
    """Fill the (n, S, S) ISAI blocks subs[i,a,b] = A(J_b, J_a) and rhs
    e_i(J) IN PLACE (subs identity-initialized, rhs zeroed; f64/c128
    contiguous).  Returns True, or None when native is unavailable."""
    L = lib()
    if L is None:
        return None
    n = p_ptr.shape[0] - 1
    is_cpx = np.iscomplexobj(a_vals)
    rc = L.gt_isai_fill(
        n, int(S), _ptr(a_ptr, ctypes.c_int64), _ptr(a_cols, ctypes.c_int64),
        a_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _ptr(p_ptr, ctypes.c_int64), _ptr(p_cols, ctypes.c_int64),
        subs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rhs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        1 if is_cpx else 0)
    return rc == 0 or None


def isai_pairs_native(S, a_ptr, a_cols, p_ptr, p_cols):
    """(dest, loc, hit) pair list for the device-resident ISAI fill
    (gt_isai_pairs_count/fill): A hits + diagonal-miss clears, in the
    (i, b, a-merge) walk order.  None when native is unavailable."""
    L = lib()
    if L is None:
        return None
    n = p_ptr.shape[0] - 1
    args = (n, int(S), _ptr(a_ptr, ctypes.c_int64),
            _ptr(a_cols, ctypes.c_int64), _ptr(p_ptr, ctypes.c_int64),
            _ptr(p_cols, ctypes.c_int64))
    count = L.gt_isai_pairs_count(*args)
    if count < 0:
        return None
    dest = np.empty(count, np.int64)
    loc = np.empty(count, np.int64)
    hit = np.empty(count, np.uint8)
    got = L.gt_isai_pairs_fill(
        *args, _ptr(dest, ctypes.c_int64), _ptr(loc, ctypes.c_int64),
        hit.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), count)
    if got != count:
        return None
    return dest, loc, hit.astype(bool)
