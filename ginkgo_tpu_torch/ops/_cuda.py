"""Build and load the hand-written CUDA kernels of ``ops/csrc/``.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``.  Nothing is built
when the package is imported: ``library(name)`` builds at first use, and
``build()`` compiles every missing library with one ``nvcc`` process per
source, all started together.  Libraries land in ``ginkgo_tpu_torch/_kernels``
under a name that carries a digest of the source and flags, so an edited
source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# vcode, xcode, dvb, offsets, D, S, n, x, ldx, y, ldy, k, stream
_DIA_ARGS = [_I, _I, _P, _P, _I, _I, _L, _P, _L, _P, _L, _I, _P]
# name -> {entry point: argtypes}; every launcher returns cudaGetLastError()
SIGNATURES = {
    # kernel A: one real column or up to 8 complex ones; its wide instance
    # for 2 to 16 real columns
    "dia_spmv": {"dia_spmv_launch": _DIA_ARGS,
                 "dia_spmv_wide_launch": _DIA_ARGS},
    # vcode, xcode, sv, sc, sp, xbase, n_slices, n, m, x, ldx, y, ldy, k,
    # stream
    "sell_spmv": {"sell_spmv_launch":
                  [_I, _I, _P, _P, _P, _P, _L, _L, _L, _P, _L, _P, _L, _I,
                   _P]},
    # xcode, inv, crossi, crossv, nwv, nb, P, Wv, n, flip, b, ldb, x, ldx,
    # k, stream
    "tri_packed": {"tri_packed_launch":
                   [_I, _P, _P, _P, _P, _I, _I, _I, _L, _I, _P, _L, _P, _L,
                    _I, _P]},
    # mode, vcode, a, na, b, nb, cl, cu, co, vstart, va, vb, tstart, T,
    # n_out, tl, tu, tseg, tpo, nseg, y, stream
    "pair_contract": {"pair_contract_launch":
                      [_I, _I, _P, _L, _P, _L, _P, _P, _P, _P, _P, _P, _P,
                       _I, _L, _P, _P, _P, _P, _I, _P, _P]},
    # dst (row i of the store), src, elements, element size, stream
    "row_write": {"row_write_launch": [_P, _P, _L, _I, _P]},
}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of ginkgo_tpu_torch "
                       "are compiled at first use and need the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every library of ``names`` that is missing, in parallel.
    Returns each compiled library's ``ptxas`` report (registers, spills);
    raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    reports, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu (exit "
                            f"{proc.returncode}):\n{stderr}{stdout}")
            continue
        os.replace(tmp, out)
        reports[name] = stderr
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for entry, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(name: str, code: int):
    """Raise when a launcher returned a CUDA error code."""
    if code != 0:
        msg = getattr(library(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")


# value/vector type codes shared with csrc/*.cu; the complex ones are taken
# by the SpMV kernels (dia_spmv.cu, sell_spmv.cu) only
TYPE_CODES = {"float32": 0, "float64": 1, "bfloat16": 2, "float16": 3,
              "complex64": 4, "complex128": 5}


def type_code(dtype) -> int:
    return TYPE_CODES[str(dtype).removeprefix("torch.")]
