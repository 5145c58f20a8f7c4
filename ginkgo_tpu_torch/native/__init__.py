"""Native C++ host tier (ctypes-loaded, numpy fallback everywhere).

The port's own copy of ``src/ginkgo_native.cpp`` (the C++ source of the JAX
package's host tier, unchanged), compiled on first use with
``g++ -O3 -march=native`` into ``lib/libginkgo_native.so`` beside this
file.  ``lib()`` returns the loaded library or None when no toolchain is
available: callers treat it as an accelerator, never a requirement, and
their numpy fallbacks give the same result.

Only the entry points the ported modules call are bound: dependency levels
(triangular solves), ILU pair lists (ParILU), exact ILU(0)/IC(0) and the
COO canonicalizer (``MatrixData.sum_duplicates``).
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
    f64p = ctypes.POINTER(ctypes.c_double)
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
