#!/usr/bin/env python3
"""On-card smoke test of ``ginkgo_tpu_torch``, the PyTorch/CUDA port.

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

1. card: name and power limit (``nvidia-smi``); exits 2 without CUDA;
2. build: compiles every hand-written kernel of ``ops/csrc`` with ``nvcc``
   (one process per source, all started together) and the port's native
   C++ host library with ``g++``;
3. kernel A (banded SpMV) against its plain PyTorch version on the card:
   small random banded matrices with k in {1, 3, 8, 9} in f32, f64 and
   bf16/f16 storage, and the 27-point stencil at nx=160 with k=1, timed
   beside its byte bound, its plain version and cuSPARSE;
4. kernel B (packed windowed-ELL SpMV), the same on small matrices and on
   the locally permuted 1,048,576-row stencil;
5. kernel C (packed exact triangular solve), the same on small random
   lower and upper factors (f32 and f64 right-hand sides) and on the L
   factor of the ILU system below, timed beside its byte bound, its plain
   version and cuSPARSE's triangular solve; four of its block inverses are
   checked against an f64 inverse, and four more built with TF32 turned
   on by the caller;
6. main path, banded: ``Csr.from_data`` of the nx=160 stencil on the card
   (``banded`` layout), Jacobi-CG to the tolerance below, with kernel A's
   launch count and the true residual recomputed independently;
7. main path, packed: the same on the permuted matrix (``packed`` layout);
8. main path, ILU: the 262,144-row unstructured FEM matrix of the
   benchmark cases (``packed`` layout), ``Ilu(ParIlu(5))`` with both
   triangular solves on kernel C, BiCGSTAB to ``ResidualNorm(1e-5)`` with
   kernels B and C counted, the true residual recomputed, and fewer
   iterations than BiCGSTAB without a preconditioner;
9. ParILUT generate: ``ParIlut(iterations=5)`` (``auto``, f32) on the ILU
   system's matrix takes the packed device loop, with exactly 42 launches
   of kernel D (23 on the product plan, 19 on the denominator plan), the
   stagetimer's host/transfer/device split, and both triangular solves of
   ``Ilu(ParIlut)`` on kernel C;
10. main path, ILUT: Ilu(ParIlut)-BiCGSTAB to ``ResidualNorm(1e-5)`` as in
   8, in fewer iterations than without a preconditioner;
11. the same generate with the one-hot scatter (``_DOT_MODE = "onehot"``):
   42 launches of kernel E and factors that agree with 9's;
12. kernels D and E (pair contraction) at the product and denominator
   plans of that generate, against their plain version and an f64
   raw-triple oracle, timed beside their byte bound, their plain version
   and the gather + ``index_add_`` of the raw triples;
13. small solves on the card agree with the port's CPU run: Jacobi-CG and
   Ic-CG in f64, Ilu-BiCGSTAB in f32 and f64, packed ParILUT and ParICT
   factors in f64, and Ilu(ParIlut)-BiCGSTAB in f32.

The line before the last is a JSON object with every kernel's launches on
the main paths, error against its plain version, time, plain time, bound
and library time (cuSPARSE for A-C; for D and E, whose contraction no
single PyTorch call computes, the gather + ``index_add_`` of the raw
pair triples, on the product plan); the last line is
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import ginkgo_tpu_torch as gtt
from ginkgo_tpu_torch import native
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.factorization import (ParIct, ParIlu, ParIlut,
                                            par_ilut_packed)
from ginkgo_tpu_torch.ops import (_cuda, pair_contract, spmv_banded,
                                  spmv_packed, tri_packed)
from ginkgo_tpu_torch.ops.spmv import coo_spmv
from ginkgo_tpu_torch.preconditioner import Ic, Ilu, Jacobi
from ginkgo_tpu_torch.solver import Bicgstab, Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.ops.tri_inv import batched_lowtri_inverse
from ginkgo_tpu_torch.utils import stagetimer
from ginkgo_tpu_torch.utils.generators import (permute_locally,
                                               random_banded,
                                               random_lower_factor,
                                               stencil_3d, symmetric_part)

# H100 SXM data sheet: memory rate
# and the non-tensor-core f32 rate the kernels' multiply-adds run at
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

BANDED_NX = 160                      # the size bench.py measures on a chip
PACKED_DIMS = (256, 64, 64)          # 1,048,576 rows once permuted
# ResidualNorm, relative to ||b||.  f32 CG on the nx=160 stencil stalls
# at a true residual of about 1.1e-4 (tools/torch_solve_probe.py), so a
# tighter tolerance ends in the audit's "stagnated"; the f64 recheck holds
# the solve to the tolerance it claims
SOLVE_TOL = 2e-4
TRUE_RESIDUAL_LIMIT = SOLVE_TOL
# the ILU path: the repo's unstructured preconditioner case, f32
ILU_CASE = {"fem": 262144, "offscale": 1.2}
ILU_TOL = 1e-5
# the ParILUT path: the JAX package's benchmark preset "parilut"
# (Ilu(factorization=ParIlut(iterations=5))); one generate with two sweeps
# an iteration contracts 23 times on the product plan and 19 times on the
# denominator plan (par_ilut_packed._run_packed)
ILUT_ITERATIONS = 5
ILUT_LAUNCHES = {"prod": 23, "den": 19}
# pair contraction against its plain version and the f64 oracle, relative
# to max |y|: f32 sums in another order, and kernel D's cumsum difference
# loses digits to cancellation (the JAX package's tolerances)
PAIR_TOL = {"pair_contract_cumsum": 1e-5, "pair_contract_onehot": 2e-5}
# kernel E's ParILUT factors against kernel D's on their shared slots,
# relative to max |value|: the threshold select reacts to f32 sums in
# another order (3.7e-3 on L and 4.5e-3 on U in three runs on the H100),
# far below the O(1) of values gone wrong
ONEHOT_FACTOR_TOL = 2e-2
DEV = torch.device("cuda")
TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-5,
       torch.float16: 1e-5}


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean ms per call from CUDA events around ``reps`` calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def stream_gbps():
    """Device copy rate: 1 GiB read + 1 GiB written per copy."""
    src = torch.empty(1 << 28, dtype=torch.float32, device=DEV)
    src.fill_(1.0)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), 20)
    return 2 * src.numel() * 4 / (ms * 1e-3) / 1e9


def rel_err(got, want):
    """max |got - want| / max |want|, in f64."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-300), scale


def bound(nbytes, nops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_ms(A, x, reps):
    """cuSPARSE's CSR SpMM on the same matrix: the yardstick the port
    itself never calls."""
    nnz = A.nnz
    S = torch.sparse_csr_tensor(A.row_ptr, A.col_idx[:nnz], A.values[:nnz],
                                size=A.shape)
    y = S @ x
    return time_ms(lambda: S @ x, reps), y


# -- kernel A -----------------------------------------------------------------
def banded_case(n, offsets, vdtype, seed):
    g = np.random.default_rng(seed)
    dv = g.standard_normal((len(offsets), n))
    for d, off in enumerate(offsets):
        if off < 0:
            dv[d, :-off] = 0
        elif off > 0:
            dv[d, n - off:] = 0
    meta = spmv_banded.plan_banded_layout(tuple(offsets), n)
    dvb = torch.from_numpy(spmv_banded.block_diag_values(dv, meta))
    return meta, dvb.to(device=DEV, dtype=vdtype)


def check_dia(offsets, dvb, meta, x):
    y = spmv_banded.dia_spmv_cuda(offsets, dvb, meta, x)
    torch.cuda.synchronize()
    want = spmv_banded.dia_spmv_reference(offsets, dvb, meta, x)
    assert y.shape == want.shape and y.dtype == x.dtype
    assert bool(torch.isfinite(y).all())
    err, _ = rel_err(y, want)
    tol = TOL[dvb.dtype]
    if not err <= tol:
        raise AssertionError(f"dia_spmv kernel disagrees: rel err {err:.3e}"
                             f" > {tol} (dvb {dvb.dtype}, x {x.dtype}, "
                             f"shape {tuple(x.shape)})")
    return err


def phase_kernel_a(A):
    worst = {}
    for n, offsets in ((1000, (-1, 0, 1)),
                       (5000, (-130, -129, -128, -1, 0, 1, 128, 129, 130)),
                       (3000, (-257, 0, 257)), (700, (0,))):
        for vdtype in (torch.float32, torch.float64, torch.bfloat16,
                       torch.float16):
            xdtype = torch.float64 if vdtype == torch.float64 \
                else torch.float32
            meta, dvb = banded_case(n, offsets, vdtype, seed=n)
            for k in (1, 3, 8, 9):
                x = torch.randn((n, k), dtype=xdtype, device=DEV)
                err = check_dia(offsets, dvb, meta, x)
                worst[str(vdtype)] = max(worst.get(str(vdtype), 0.0), err)
    say("kernel_a_small", max_rel_err=worst)

    n = A.shape[0]
    offsets, meta = A.diag_offsets, dict(A.band_meta)
    x = torch.randn((n, 1), dtype=torch.float32, device=DEV)
    y = spmv_banded.dia_spmv_cuda(offsets, A.diag_values, meta, x)
    want = spmv_banded.dia_spmv_reference(offsets, A.diag_values, meta, x)
    err, scale = rel_err(y, want)
    if not err <= TOL[torch.float32]:
        raise AssertionError(f"dia_spmv kernel disagrees at nx={BANDED_NX}:"
                             f" rel err {err:.3e}")
    ms = time_ms(lambda: spmv_banded.dia_spmv_cuda(
        offsets, A.diag_values, meta, x), 50)
    plain = time_ms(lambda: spmv_banded.dia_spmv_reference(
        offsets, A.diag_values, meta, x), 10)
    lib, ylib = library_ms(A, x, 20)
    lib_err, _ = rel_err(ylib, want)
    D = len(offsets)
    nbytes = D * n * A.diag_values.element_size() + 2 * n * 4
    bms, by = bound(nbytes, 2 * D * n)
    say("kernel_a", n=n, D=D, k=1, ms=ms, plain_ms=plain, library_ms=lib,
        bound_ms=bms, bound_by=by, bytes=nbytes,
        effective_GBps=nbytes / (ms * 1e-3) / 1e9,
        max_abs_err=err * scale, max_rel_err=err, library_rel_err=lib_err)
    return dict(name="dia_spmv", route="cuda",
                source="ginkgo_tpu_torch/ops/csrc/dia_spmv.cu",
                replaces="ginkgo_tpu/ops/spmv_pallas.py:98",
                max_abs_err=err * scale, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib)


# -- kernel B -----------------------------------------------------------------
def pell_args(A, vdtype):
    return (A.pell_vals.to(vdtype), A.pell_idx, A.pell_qw, A.pell_xbase,
            A.pell_meta)


def check_pell(args, x):
    y = spmv_packed.pell_spmv_cuda(*args, x)
    torch.cuda.synchronize()
    want = spmv_packed.pell_spmv_reference(*args, x)
    assert y.shape == want.shape and y.dtype == x.dtype
    assert bool(torch.isfinite(y).all())
    err, _ = rel_err(y, want)
    tol = TOL[args[0].dtype]
    if not err <= tol:
        raise AssertionError(f"pell_spmv kernel disagrees: rel err {err:.3e}"
                             f" > {tol} (vals {args[0].dtype}, x {x.dtype},"
                             f" shape {tuple(x.shape)})")
    return err


def small_packed_matrices():
    g = np.random.default_rng(11)
    n, n_off = 3000, 24               # the FEM-like pattern of the tests
    offs = g.integers(-500, 500, (-(-n // 128), n_off))
    pick = g.random((n, n_off)) < 0.6
    r = np.repeat(np.arange(n), n_off).reshape(n, n_off)
    c = np.clip(r + offs[np.arange(n) // 128], 0, n - 1)
    yield gtt.MatrixData((n, n), r[pick], c[pick],
                         g.standard_normal(int(pick.sum())))
    yield permute_locally(stencil_3d(16, 16, 8, points=27))
    # rectangular: 1100 x 900 with local columns
    rows = np.repeat(np.arange(1100), 6)
    cols = np.minimum(rows * 900 // 1100 + g.integers(0, 40, rows.size), 899)
    yield gtt.MatrixData((1100, 900), rows, cols,
                         g.standard_normal(rows.size))


def phase_kernel_b(A):
    worst = {}
    for data in small_packed_matrices():
        S = gtt.Csr.from_data(data, strategy="packed")
        assert S.strategy == "packed"
        for vdtype in (torch.float32, torch.float64, torch.bfloat16,
                       torch.float16):
            xdtype = torch.float64 if vdtype == torch.float64 \
                else torch.float32
            args = pell_args(S, vdtype)
            for k in (1, 3, 8, 9):
                x = torch.randn((S.shape[1], k), dtype=xdtype, device=DEV)
                err = check_pell(args, x)
                worst[str(vdtype)] = max(worst.get(str(vdtype), 0.0), err)
    say("kernel_b_small", max_rel_err=worst)

    n, m = A.shape
    args = pell_args(A, torch.float32)
    x = torch.randn((m, 1), dtype=torch.float32, device=DEV)
    y = spmv_packed.pell_spmv_cuda(*args, x)
    want = spmv_packed.pell_spmv_reference(*args, x)
    err, scale = rel_err(y, want)
    if not err <= TOL[torch.float32]:
        raise AssertionError(f"pell_spmv kernel disagrees on the packed "
                             f"main-path matrix: rel err {err:.3e}")
    ms = time_ms(lambda: spmv_packed.pell_spmv_cuda(*args, x), 50)
    plain = time_ms(lambda: spmv_packed.pell_spmv_reference(*args, x), 5)
    lib, ylib = library_ms(A, x, 20)
    lib_err, _ = rel_err(ylib, want)
    meta = dict(A.pell_meta)
    slots = A.pell_vals.numel()
    nbytes = (slots * (A.pell_vals.element_size() + 2)
              + A.pell_qw.numel() * 4 + A.pell_xbase.numel() * 4
              + m * 4 + n * 4)
    bms, by = bound(nbytes, 2 * slots)
    say("kernel_b", n=n, Wv=meta["Wv"], XW=meta["XW"], k=1, slots=slots,
        nnz=A.nnz, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
        bound_by=by, bytes=nbytes,
        effective_GBps=nbytes / (ms * 1e-3) / 1e9,
        max_abs_err=err * scale, max_rel_err=err, library_rel_err=lib_err)
    return dict(name="pell_spmv", route="cuda",
                source="ginkgo_tpu_torch/ops/csrc/pell_spmv.cu",
                replaces="ginkgo_tpu/ops/spmv_packed.py:235",
                max_abs_err=err * scale, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib)


# -- kernel C -----------------------------------------------------------------
# the random unstructured lower factors of the JAX package's packed-trisolve
# tests: (n, entries per row, reach, seed, off-diagonal scale); n = 1700
# gives an odd block count
SMALL_FACTORS = ((1500, 7, 500, 5, 0.05), (1700, 7, 600, 7, 0.04),
                 (1200, 5, 400, 9, 0.04))


def check_tri(arrays, meta, b):
    x = tri_packed.packed_trisolve_cuda(arrays, meta, b)
    torch.cuda.synchronize()
    want = tri_packed.packed_trisolve_reference(arrays, meta, b)
    assert x.shape == want.shape and x.dtype == b.dtype
    assert bool(torch.isfinite(x).all())
    err, _ = rel_err(x, want)
    if not err <= TOL[torch.float32]:
        raise AssertionError(f"tri_packed kernel disagrees: rel err "
                             f"{err:.3e} (b {b.dtype}, shape "
                             f"{tuple(b.shape)}, meta {dict(meta)})")
    return err


def tri_library_ms(L, b, reps):
    """cuSPARSE's triangular solve (``torch.triangular_solve`` on the
    factor as a sparse CSR tensor): the yardstick the port itself never
    calls.  Returns (ms, x), or (None, the error text) when the installed
    PyTorch refuses the sparse factor."""
    nnz = L.nnz
    S = torch.sparse_csr_tensor(L.row_ptr, L.col_idx[:nnz], L.values[:nnz],
                                size=L.shape)
    try:
        x = torch.triangular_solve(b, S, upper=False).solution
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        return None, f"{type(exc).__name__}: {exc}"
    return time_ms(lambda: torch.triangular_solve(b, S, upper=False),
                   reps), x


def inverse_check(L, arrays, nb):
    """Max relative difference of four built block inverses against an
    f64 ``numpy.linalg.inv`` of the same within-block triangles."""
    d = L.to_matrix_data()
    r, c = d.row_idx.astype(np.int64), d.col_idx.astype(np.int64)
    worst = 0.0
    for t in sorted({0, 1, nb // 2, nb - 1}):
        sel = (r // 256 == t) & (c // 256 == t)
        Lb = np.eye(256)
        Lb[r[sel] - 256 * t, c[sel] - 256 * t] = d.values[sel]
        want = np.linalg.inv(Lb)
        got = arrays["inv"][t].double().cpu().numpy()
        worst = max(worst, float(np.abs(got - want).max()
                                 / np.abs(want).max()))
    if not worst <= 1e-5:
        raise AssertionError(f"built block inverses differ from the f64 "
                             f"inverse by {worst:.3e} (relative)")
    return worst


def inverse_check_tf32_on():
    """The block-inverse build after the caller turned TF32 on: four dense
    lower blocks (TF32 products would miss the f64 inverse by about 1e-4)
    must stay within 1e-5 of it, and the caller's setting must survive."""
    g = np.random.default_rng(0)
    Lb = np.tril(g.standard_normal((4, 256, 256)) * 0.1, -1)
    Lb[:, np.arange(256), np.arange(256)] = 2.0 + g.random((4, 256))
    want = np.linalg.inv(Lb)
    flags = torch.backends.cuda.matmul
    prev = flags.fp32_precision
    torch.set_float32_matmul_precision("high")
    try:
        got = batched_lowtri_inverse(torch.from_numpy(Lb).float().to(DEV))
        got = got.double().cpu().numpy()
        kept = flags.fp32_precision
    finally:
        torch.set_float32_matmul_precision("highest")
        flags.fp32_precision = prev
    worst = max(float(np.abs(got[i] - want[i]).max() / np.abs(want[i]).max())
                for i in range(4))
    if kept != "tf32" or not worst <= 1e-5:
        raise AssertionError(f"with TF32 on, built block inverses differ "
                             f"from the f64 inverse by {worst:.3e} and the "
                             f"caller's flag reads {kept!r}")
    return worst


def tri_needed_bytes_ops(arrays, n, nb):
    """Bytes and operations the solve needs at least: the inverse entries
    on or below the diagonal in rows < n (the rest are exact zeros or rows
    past the end), the nonzero cross slots (int16 index and f32 value),
    ``nwv``, b read once and x written once."""
    rows = np.minimum(256, n - 256 * np.arange(nb))
    inv_entries = int((rows * (rows + 1) // 2).sum())
    cross = int((arrays["crossv"] != 0).sum())
    nbytes = inv_entries * 4 + cross * 6 + nb * 4 + 2 * n * 4
    return nbytes, 2 * inv_entries + 2 * cross, inv_entries, cross


def phase_kernel_c(op, L):
    worst = {}
    for n, per, reach, seed, scale in SMALL_FACTORS:
        d = random_lower_factor(n, per, reach, seed, scale)
        for lower in (True, False):
            dd = d if lower else gtt.MatrixData(
                (n, n), d.col_idx.copy(), d.row_idx.copy(),
                d.values.copy()).canonical()
            arrays, meta = tri_packed.plan_packed_trisolve(dd, lower, False,
                                                           device=DEV)
            for xdtype in (torch.float32, torch.float64):
                for k in (1, 3, 8, 9):
                    b = torch.randn((n, k), dtype=xdtype, device=DEV)
                    err = check_tri(arrays, meta, b)
                    worst[str(xdtype)] = max(worst.get(str(xdtype), 0.0),
                                             err)
    say("kernel_c_small", max_rel_err=worst)

    arrays, meta_items = op.pk_arrays, op.tri_meta
    meta = dict(meta_items)
    n, nb = meta["n"], meta["nb"]
    b = torch.randn((n, 1), dtype=torch.float32, device=DEV)
    x = tri_packed.packed_trisolve_cuda(arrays, meta_items, b)
    want = tri_packed.packed_trisolve_reference(arrays, meta_items, b)
    err, scale = rel_err(x, want)
    if not err <= TOL[torch.float32]:
        raise AssertionError(f"tri_packed kernel disagrees on the ILU "
                             f"factor: rel err {err:.3e}")
    ms = time_ms(lambda: tri_packed.packed_trisolve_cuda(
        arrays, meta_items, b), 20)
    plain = time_ms(lambda: tri_packed.packed_trisolve_reference(
        arrays, meta_items, b), 3)
    lib, ylib = tri_library_ms(L, b, 5)
    lib_note = (dict(library_rel_err=rel_err(ylib, want)[0]) if lib
                is not None else dict(library_error=ylib))
    inv_err = inverse_check(L, arrays, nb)
    inv_err_tf32 = inverse_check_tf32_on()
    nbytes, nops, inv_entries, cross = tri_needed_bytes_ops(arrays, n, nb)
    bms, by = bound(nbytes, nops)
    say("kernel_c", meta=meta, k=1, ms=ms, plain_ms=plain, library_ms=lib,
        bound_ms=bms, bound_by=by, bytes=nbytes,
        inverse_entries=inv_entries, cross_entries=cross,
        effective_GBps=nbytes / (ms * 1e-3) / 1e9,
        max_abs_err=err * scale, max_rel_err=err,
        inverse_rel_err_vs_f64=inv_err,
        inverse_rel_err_vs_f64_tf32_on=inv_err_tf32, **lib_note)
    return dict(name="tri_packed", route="cuda",
                source="ginkgo_tpu_torch/ops/csrc/tri_packed.cu",
                replaces="ginkgo_tpu/ops/tri_packed.py:178",
                max_abs_err=err * scale, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib)


# -- main path ----------------------------------------------------------------
COUNTERS = {"dia_spmv": spmv_banded.dia_spmv_cuda,
            "pell_spmv": spmv_packed.pell_spmv_cuda,
            "tri_packed": tri_packed.packed_trisolve_cuda,
            "pair_contract_cumsum": pair_contract.pair_contract_cumsum_cuda,
            "pair_contract_onehot": pair_contract.pair_contract_onehot_cuda}


def reset_counters():
    torch.cuda.synchronize()
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counters():
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in COUNTERS.items()}


def true_rel_residual(A, b, x):
    """||b - A x|| / ||b|| in f64 on the card, by the plain COO product."""
    x = x.double()
    r = b.double() - coo_spmv(A.row_idx, A.col_idx, A.values, x[:, None],
                              A.shape[0])[:, 0]
    return float(r.norm() / b.double().norm())


def main_path(label, A, strategy, kernel):
    """Jacobi-CG on ``A`` through the port's entry points; returns every
    kernel's launches during the solve."""
    assert A.strategy == strategy, (label, A.strategy)
    n = A.shape[0]
    b = torch.ones(n, dtype=torch.float32, device=DEV)
    reset_counters()
    t0 = time.perf_counter()
    res = Cg.solve(A, b, criteria=Iteration(2000) | ResidualNorm(SOLVE_TOL),
                   preconditioner=Jacobi())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    true_rel = true_rel_residual(A, b, res.x)
    iters = int(res.iterations[0])
    say(f"main_{label}", n=n, nnz=A.nnz, strategy=A.strategy,
        iterations=iters, converged=bool(res.converged.all()),
        stagnated=bool(res.stagnated.any()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        true_rel_residual=true_rel, launches=launches)
    if launches[kernel] <= 0:
        raise AssertionError(f"{label}: the solve never launched {kernel}")
    if not bool(res.converged.all()):
        raise AssertionError(f"{label}: CG did not converge")
    if not (np.isfinite(true_rel) and true_rel <= TRUE_RESIDUAL_LIMIT):
        raise AssertionError(f"{label}: true relative residual {true_rel:.3e}"
                             f" > {TRUE_RESIDUAL_LIMIT}")
    return launches


def ilu_solve(A, M):
    """BiCGSTAB with ``M`` on ``A`` to ``ILU_TOL``, b = ones, through the
    port's entry points; the kernel counts are zeroed just before the
    solve and read just after.  Returns (result, seconds, launches, true
    relative residual)."""
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    reset_counters()
    t0 = time.perf_counter()
    res = Bicgstab.solve(A, b, criteria=Iteration(1000) | ResidualNorm(ILU_TOL),
                         preconditioner=M)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    return res, seconds, launches, true_rel_residual(A, b, res.x)


def ilu_breakdown(A, M):
    """Outside the counted window: the seconds of a second, warm solve,
    and one kernel-C launch on each factor (CUDA events), for the split of
    an iteration."""
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Bicgstab.solve(A, b, criteria=Iteration(1000) | ResidualNorm(ILU_TOL),
                   preconditioner=M)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    x = b[:, None]
    c_ms = {name: time_ms(lambda op=op: tri_packed.packed_trisolve_cuda(
        op.pk_arrays, op.tri_meta, x), 10)
        for name, op in (("l", M.l_solver), ("u", M.u_solver))}
    return dict(warm_solve_s=warm, kernel_c_ms=c_ms)


def check_ilu_solve(label, res, launches, true_rel, bare_iters):
    iters = int(res.iterations[0])
    if launches["pell_spmv"] <= 0:
        raise AssertionError(f"{label}: the solve never launched pell_spmv")
    if launches["tri_packed"] < 4 * iters or iters <= 0:
        raise AssertionError(f"{label}: {launches['tri_packed']} tri_packed"
                             f" launches for {iters} iterations (two ILU "
                             f"applies of two solves each per iteration)")
    if not bool(res.converged.all()):
        raise AssertionError(f"{label}: BiCGSTAB did not converge")
    if not (np.isfinite(true_rel) and true_rel <= ILU_TOL):
        raise AssertionError(f"{label}: true relative residual "
                             f"{true_rel:.3e} > {ILU_TOL}")
    if not iters < bare_iters:
        raise AssertionError(f"{label}: {iters} iterations with the "
                             f"preconditioner, {bare_iters} without")


def main_ilu(A, M):
    """Ilu-BiCGSTAB on ``A``; returns every kernel's launches during the
    solve, its iterations and those of BiCGSTAB without a preconditioner,
    which runs afterwards, outside the counted window."""
    assert A.strategy == "packed", A.strategy
    res, seconds, launches, true_rel = ilu_solve(A, M)
    iters = int(res.iterations[0])
    b = torch.ones(A.shape[0], dtype=torch.float32, device=DEV)
    t0 = time.perf_counter()
    bare = Bicgstab.solve(A, b, criteria=Iteration(1000)
                          | ResidualNorm(ILU_TOL))
    torch.cuda.synchronize()
    bare_seconds = time.perf_counter() - t0
    bare_iters = int(bare.iterations[0])
    say("main_ilu", n=A.shape[0], nnz=A.nnz, strategy=A.strategy,
        iterations=iters, converged=bool(res.converged.all()),
        stagnated=bool(res.stagnated.any()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        true_rel_residual=true_rel, launches=launches,
        unpreconditioned_iterations=bare_iters,
        unpreconditioned_converged=bool(bare.converged.all()),
        unpreconditioned_solve_s=bare_seconds,
        unpreconditioned_true_rel_residual=true_rel_residual(A, b, bare.x),
        **ilu_breakdown(A, M))
    check_ilu_solve("ILU path", res, launches, true_rel, bare_iters)
    return launches, iters, bare_iters


def main_ilut(A, M, parilu_iters, bare_iters):
    """Ilu(ParIlut)-BiCGSTAB on ``A``, held to what ``main_ilu`` holds."""
    res, seconds, launches, true_rel = ilu_solve(A, M)
    iters = int(res.iterations[0])
    say("main_ilut", n=A.shape[0], iterations=iters,
        converged=bool(res.converged.all()),
        stagnated=bool(res.stagnated.any()), solve_s=seconds,
        ms_per_iteration=seconds * 1e3 / max(iters, 1),
        true_rel_residual=true_rel, launches=launches,
        parilu_iterations=parilu_iters,
        unpreconditioned_iterations=bare_iters, **ilu_breakdown(A, M))
    check_ilu_solve("ILUT path", res, launches, true_rel, bare_iters)
    return launches


# -- the ParILUT path -----------------------------------------------------------
def _no_planning(*args, **kw):
    raise AssertionError("the packed ParILUT plan cache missed: the kernel "
                         "phases would plan again")


def ilut_plan(A):
    """The kernel-tier packed ParILUT plan of ``A``, served by the
    single-slot plan cache that the generate filled."""
    d = A.to_matrix_data().canonical()
    return par_ilut_packed._cached_plan(
        d, "ilut", 3, ParIlut().fill_in_limit, _no_planning, device=DEV)


@contextlib.contextmanager
def plan_tally():
    """Within the block, the plan meta of every pair-contraction kernel
    launch, seen from outside the wrappers (whose counts stay the ones
    read); ``by_plan`` splits them by plan."""
    metas = []
    real = pair_contract._launch

    def seen(kernel, mode, a, b, arrs, meta_items):
        metas.append(meta_items)
        return real(kernel, mode, a, b, arrs, meta_items)

    pair_contract._launch = seen
    try:
        yield metas
    finally:
        pair_contract._launch = real


def by_plan(metas, plan):
    """Launches on each of ``plan``'s two contraction plans: the generate
    hands the kernels the plan's own meta object."""
    return {name: sum(m is plan[name]["kernel"]["meta"] for m in metas)
            for name in ("prod", "den")}


def ilut_generate(A):
    """``Ilu(factorization=ParIlut(iterations=5))`` on the card, the
    factorization counted as a main path of its own: kernel D's launches
    with their split by plan, and the stage split of the generate."""
    reset_counters()
    t0 = time.perf_counter()
    with stagetimer.collect() as st, plan_tally() as metas:
        F = ParIlut(iterations=ILUT_ITERATIONS).generate(A)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_counters()
    plan = ilut_plan(A)
    split = by_plan(metas, plan)
    M = Ilu(factorization=F).generate(A)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    metas = {name: {**dict(plan[name]["kernel"]["meta"]),
                    "fill": plan[name]["kernel"]["fill"],
                    "tail": int(len(plan[name]["kernel"]["tail"][0])),
                    "pairs": int(len(plan[name]["raw"][0])),
                    "live_vregs": int(plan[name]["kernel"]["nv"].sum())}
             for name in ("prod", "den")}
    transfer = st.stages.get("transfer", 0.0)
    device = st.stages.get("device", 0.0)
    say("ilut_generate", seconds=t2 - t0, factorization_s=t1 - t0,
        host_s=t1 - t0 - transfer - device, transfer_s=transfer,
        device_s=device, trisolve_generate_s=t2 - t1, nl=plan["nl"],
        nu=plan["nu"], plans=metas, l_nnz=F.l_factor.nnz,
        u_nnz=F.u_factor.nnz, l_algorithm=M.l_solver.algorithm,
        u_algorithm=M.u_solver.algorithm,
        l_meta=dict(M.l_solver.tri_meta or ()),
        u_meta=dict(M.u_solver.tri_meta or ()), launches=launches,
        kernel_d_by_plan=split, route=F.route)
    if F.route != "packed":
        raise AssertionError(f"ParILUT generate took the {F.route} route")
    if split != ILUT_LAUNCHES or launches["pair_contract_cumsum"] != 42:
        raise AssertionError(f"ParILUT generate: kernel D launches {split} "
                             f"(total {launches['pair_contract_cumsum']}); "
                             f"the packed route takes {ILUT_LAUNCHES}")
    if not (M.l_solver.algorithm == M.u_solver.algorithm == "exact_packed"):
        raise AssertionError(f"ParILUT factors plan to "
                             f"{M.l_solver.algorithm}/{M.u_solver.algorithm}")
    for f in (F.l_factor, F.u_factor):
        if not bool(torch.isfinite(f.values[:f.nnz]).all()):
            raise AssertionError("ParILUT factors hold non-finite values")
    return F, M, plan, launches


def _pattern_keys(op):
    d = op.to_matrix_data()
    return d.row_idx.astype(np.int64) * d.shape[1] + d.col_idx, d.values


def ilut_generate_onehot(A, F_ref, plan):
    """The same generate with the one-hot scatter (kernel E), counted as a
    main path of its own; its factors against those of kernel D's run: the
    two sum in other orders, so the threshold select may keep a few other
    slots and the values on the shared ones differ a little."""
    prev = pair_contract._DOT_MODE
    pair_contract._DOT_MODE = "onehot"
    try:
        reset_counters()
        t0 = time.perf_counter()
        with plan_tally() as metas:
            F = ParIlut(iterations=ILUT_ITERATIONS).generate(A)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counters()
    finally:
        pair_contract._DOT_MODE = prev
    split = by_plan(metas, plan)
    agree = {}
    for name in ("l_factor", "u_factor"):
        (k1, v1), (k2, v2) = (_pattern_keys(getattr(f, name))
                              for f in (F, F_ref))
        common, i1, i2 = np.intersect1d(k1, k2, return_indices=True)
        agree[name] = dict(
            nnz=int(k1.size), nnz_kernel_d=int(k2.size),
            shared=float(common.size / max(k2.size, 1)),
            max_rel_diff_shared=float(np.abs(v1[i1].astype(np.float64)
                                             - v2[i2]).max()
                                      / np.abs(v2).max()))
    say("ilut_generate_onehot", seconds=seconds, launches=launches,
        kernel_e_by_plan=split, against_kernel_d=agree)
    if split != ILUT_LAUNCHES or launches["pair_contract_cumsum"] != 0:
        raise AssertionError(f"one-hot ParILUT generate: kernel E launches "
                             f"{split}, kernel D "
                             f"{launches['pair_contract_cumsum']}")
    for name, a in agree.items():
        if not a["shared"] >= 0.99:
            raise AssertionError(f"one-hot ParILUT {name}: only "
                                 f"{a['shared']:.4f} of kernel D's pattern")
        if not a["max_rel_diff_shared"] <= ONEHOT_FACTOR_TOL:
            raise AssertionError(f"one-hot ParILUT {name}: values on the "
                                 f"shared slots differ by "
                                 f"{a['max_rel_diff_shared']:.3e} > "
                                 f"{ONEHOT_FACTOR_TOL}")
    return launches


# -- kernels D and E -------------------------------------------------------------
PLAN_STREAMS = ("pls", "pus", "pos", "pes", "pesp", "lq", "uq", "nv", "lbase",
                "ubase")


def contraction_case(cplan, seed):
    """f32 operands from a numpy seed, every stream of the kernel plan and
    the raw triple on the card."""
    k = cplan["kernel"]
    meta = dict(k["meta"])
    g = np.random.default_rng(seed)
    a = torch.from_numpy(g.standard_normal(meta["n_a"]).astype(
        np.float32)).to(DEV)
    b = torch.from_numpy(g.standard_normal(meta["n_b"]).astype(
        np.float32)).to(DEV)
    arrs = {name: torch.from_numpy(k[name]).to(DEV) for name in PLAN_STREAMS}
    arrs["tail"] = tuple(torch.from_numpy(t).to(DEV).long()
                         for t in k["tail"])
    raw = tuple(torch.from_numpy(t).to(DEV).long() for t in cplan["raw"])
    return a, b, arrs, k["meta"], raw


def pair_needed_bytes_ops(cplan, itemsize=4):
    """Bytes and operations the contraction needs at least, the same for
    kernels D and E: each planned pair's three int16 indices (6 B; the
    padding slots of the streams are the layout's, not the function's),
    the live vregs' window starts, the per-tile tables, a and b read once,
    y written once, and the tail's indices (12 B a pair; its values are
    reads of a and b); a multiply and an add a pair."""
    k = cplan["kernel"]
    meta = dict(k["meta"])
    live = int(k["nv"].sum())
    pairs = len(cplan["raw"][0])
    tail = len(k["tail"][0])
    nbytes = ((pairs - tail) * 6 + live * 8 + meta["T"] * 12
              + (meta["n_a"] + meta["n_b"] + meta["n_out"]) * itemsize
              + tail * 12)
    return nbytes, 2 * pairs


def check_pair(name, mode, cplan, seed):
    """One kernel on one plan: error against the plain version and the
    f64 oracle, then times.  Returns the phase's fields."""
    a, b, arrs, meta, raw = contraction_case(cplan, seed)
    n_out = dict(meta)["n_out"]
    prev = pair_contract._DOT_MODE
    pair_contract._DOT_MODE = mode
    try:
        fn = pair_contract.pair_contract_planned_cuda
        y = fn(a, b, arrs, meta)
        torch.cuda.synchronize()
        plain = pair_contract.pair_contract_planned_reference(a, b, arrs,
                                                              meta)
        oracle = pair_contract.pair_contract_reference(a.double(),
                                                       b.double(), *raw,
                                                       n_out)
        assert y.shape == plain.shape == (n_out,) and y.dtype == a.dtype
        assert bool(torch.isfinite(y).all())
        err_plain, scale = rel_err(y, plain)
        err_oracle, _ = rel_err(y, oracle)
        tol = PAIR_TOL[name]
        if not (err_plain <= tol and err_oracle <= tol):
            raise AssertionError(f"{name} disagrees: rel err {err_plain:.3e}"
                                 f" to its plain version, {err_oracle:.3e} "
                                 f"to the f64 oracle (tol {tol})")
        ms = time_ms(lambda: fn(a, b, arrs, meta), 20)
        plain_ms = time_ms(lambda: pair_contract.pair_contract_planned_reference(
            a, b, arrs, meta), 3)
    finally:
        pair_contract._DOT_MODE = prev
    lib = time_ms(lambda: pair_contract.pair_contract_reference(
        a, b, *raw, n_out), 10)
    nbytes, nops = pair_needed_bytes_ops(cplan)
    bms, by = bound(nbytes, nops)
    # what the kernel streams of int16 indices, padding slots included
    index_stream_bytes = (int(cplan["kernel"]["nv"].sum()) * 1024 * 2
                          * (4 if mode == "cumsum_batched" else 3))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bms,
                bound_by=by, bytes=nbytes,
                index_stream_bytes=index_stream_bytes, pairs=nops // 2,
                effective_GBps=nbytes / (ms * 1e-3) / 1e9,
                max_abs_err=err_plain * scale, max_rel_err=err_plain,
                max_rel_err_vs_f64_oracle=err_oracle)


def phase_kernels_de(plan):
    """Kernels D and E at the ParILUT path's product and denominator
    plans.  The ``kernels`` line carries the product plan's numbers (23 of
    the 42 launches of a generate, and most of its time)."""
    out = []
    for name, mode, src_line in (
            ("pair_contract_cumsum", "cumsum_batched", 535),
            ("pair_contract_onehot", "onehot", 412)):
        fields = {pname: check_pair(name, mode, plan[pname], seed)
                  for pname, seed in (("prod", 31), ("den", 32))}
        say("kernel_d" if mode == "cumsum_batched" else "kernel_e",
            name=name, plans=fields)
        out.append(dict(name=name, route="cuda",
                        source="ginkgo_tpu_torch/ops/csrc/pair_contract.cu",
                        replaces=f"ginkgo_tpu/ops/pair_contract.py:{src_line}",
                        **{key: fields["prod"][key] for key in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}))
    return out


def small_ilu_solves_match_cpu():
    """Ilu/Ic-preconditioned solves on the card against the same solves
    on the host."""
    fem = build_matrix_data({"fem": 4096, "offscale": 1.2})
    b = np.random.default_rng(2).standard_normal((4096, 3))
    cases = (
        # f32 ParILU factors on both devices (index_add_ sums in another
        # order on the card), both solves on kernel C / its plain version
        ("ilu_f32", fem, np.float32, Bicgstab, "packed",
         lambda: Ilu(factorization=ParIlu(5)), 1e-5),
        ("ic_f64", stencil_3d(12, points=27), np.float64, Cg,
         "automatical", Ic, 1e-10),
        ("ilu_f64", fem, np.float64, Bicgstab, "automatical", Ilu, 1e-10))
    for label, data, dtype, solver, strategy, precond, tol in cases:
        rhs = b[:data.shape[0]].astype(dtype)
        out = []
        for dev in (DEV, torch.device("cpu")):
            A = gtt.Csr.from_data(data, dtype=dtype, strategy=strategy,
                                  device=dev)
            M = precond().generate(A)
            res = solver.solve(A, torch.from_numpy(rhs).to(dev),
                               criteria=Iteration(300) | ResidualNorm(tol),
                               preconditioner=M)
            out.append(((M.l_solver.algorithm, M.u_solver.algorithm),
                        res.iterations.cpu(), res.converged.cpu(),
                        res.x.cpu()))
        (ag, ig, cg, xg), (ac, ic, cc, xc) = out
        assert bool(cg.all()) and bool(cc.all()), (label, cg, cc)
        if label == "ilu_f32":
            assert ag == ac == ("exact_packed", "exact_packed"), (ag, ac)
            assert int((ig - ic).abs().max()) <= 1, (ig, ic)
            err, _ = rel_err(xg, xc)
            assert err <= 1e-4, (label, err)
        else:
            # the card takes #levels jacobi sweeps where the off part
            # plans to a fast layout; the host always the level solve
            if label == "ic_f64":
                assert ag == ac == ("exact", "exact"), (ag, ac)
            assert torch.equal(ig, ic), (label, ig, ic)
            torch.testing.assert_close(xg, xc, rtol=1e-9, atol=1e-9)
        say("small_solve", case=label, card_algorithms=ag,
            host_algorithms=ac, card_iterations=ig.tolist(),
            host_iterations=ic.tolist())


def _assert_factors_match(label, Fg, Fc, rtol):
    for name in ("l_factor", "u_factor"):
        g = getattr(Fg, name).to_matrix_data()
        c = getattr(Fc, name).to_matrix_data()
        if not (np.array_equal(g.row_idx, c.row_idx)
                and np.array_equal(g.col_idx, c.col_idx)):
            raise AssertionError(f"{label} {name}: card and host patterns "
                                 f"differ ({g.nnz} vs {c.nnz} entries)")
        err = float(np.abs(g.values - c.values).max()
                    / np.abs(c.values).max())
        if not err <= rtol:
            raise AssertionError(f"{label} {name}: card and host values "
                                 f"differ by {err:.3e} (relative)")


def small_ilut_match_cpu():
    """Packed ParILUT/ParICT on small matrices, card (kernel D, f64
    instantiation) against host (the raw triples); then an
    Ilu(ParIlut)-BiCGSTAB f32 solve on both.  ParICT runs on symmetric
    matrices (the FEM case's packed ParICT plan declines on the kernel
    tier, and a nonsymmetric matrix amplifies rounding through its square
    roots)."""
    fem = build_matrix_data({"fem": 4096, "offscale": 1.2})
    band = random_banded(3000, 40, 8, seed=1)
    cases = (("parilut_fem", fem, ParIlut), ("parilut_band", band, ParIlut),
             ("parict_band", symmetric_part(band), ParIct),
             ("parict_band_narrow",
              symmetric_part(random_banded(800, 10, 5, seed=5)), ParIct))
    for label, data, P in cases:
        out = []
        for dev in (DEV, torch.device("cpu")):
            A = gtt.Csr.from_data(data, dtype=np.float64, device=dev)
            reset_counters()
            F = P(iterations=3, algorithm="packed").generate(A)
            out.append((F, read_counters()["pair_contract_cumsum"]))
        (Fg, ng), (Fc, nc) = out
        if ng <= 0 or nc != 0:
            raise AssertionError(f"{label}: kernel D launched {ng} times on "
                                 f"the card and {nc} on the host")
        _assert_factors_match(label, Fg, Fc, 1e-10)
        say("small_parilut", case=label, n=data.shape[0],
            kernel_d_launches=ng, l_nnz=Fg.l_factor.nnz,
            u_nnz=Fg.u_factor.nnz)
    b = np.random.default_rng(3).standard_normal((4096, 3)).astype(
        np.float32)
    out = []
    for dev in (DEV, torch.device("cpu")):
        A = gtt.Csr.from_data(fem, dtype=np.float32, strategy="packed",
                              device=dev)
        M = Ilu(factorization=ParIlut(iterations=5,
                                      algorithm="packed")).generate(A)
        res = Bicgstab.solve(A, torch.from_numpy(b).to(dev),
                             criteria=Iteration(300) | ResidualNorm(1e-5),
                             preconditioner=M)
        out.append(((M.l_solver.algorithm, M.u_solver.algorithm),
                    res.iterations.cpu(), res.converged.cpu(), res.x.cpu()))
    (ag, ig, cg, xg), (ac, ic, cc, xc) = out
    assert bool(cg.all()) and bool(cc.all()), (cg, cc)
    assert ag == ac == ("exact_packed", "exact_packed"), (ag, ac)
    assert int((ig - ic).abs().max()) <= 1, (ig, ic)
    say("small_solve", case="ilut_f32", card_algorithms=ag,
        host_algorithms=ac, card_iterations=ig.tolist(),
        host_iterations=ic.tolist(), x_rel_diff=rel_err(xg, xc)[0])


def small_solves_match_cpu():
    """f64 Jacobi-CG on the card against the same solve on the host."""
    for data in (stencil_3d(12, points=27),
                 permute_locally(stencil_3d(16, 16, 8, points=27))):
        b = np.random.default_rng(1).standard_normal((data.shape[0], 3))
        crit = Iteration(500) | ResidualNorm(1e-10)
        out = []
        for dev in (DEV, torch.device("cpu")):
            A = gtt.Csr.from_data(data, device=dev)
            res = Cg.solve(A, torch.from_numpy(b).to(dev), criteria=crit,
                           preconditioner=Jacobi())
            out.append((A.strategy, res.iterations.cpu(),
                        res.converged.cpu(), res.x.cpu()))
        (sg, ig, cg, xg), (sc, ic, cc, xc) = out
        assert sg == sc and torch.equal(ig, ic) and torch.equal(cg, cc), \
            (sg, ig, cg, sc, ic, cc)
        assert bool(cg.all())
        torch.testing.assert_close(xg, xc, rtol=1e-9, atol=1e-9)
        say("small_f64_solve", strategy=sg, iterations=ig.tolist())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    reports = _cuda.build()
    for name in _cuda.SIGNATURES:
        _cuda.library(name)
    regs = {name: sorted({line.split("Used ")[1].split(",")[0]
                          for line in rep.splitlines() if "Used " in line})
            for name, rep in reports.items()}
    spills = {name: sum("spill" in ln and " 0 bytes spill" not in ln
                        for ln in rep.splitlines())
              for name, rep in reports.items()}
    say("build", seconds=time.perf_counter() - t0, registers=regs,
        lines_with_spills=spills)
    t0 = time.perf_counter()
    prebuilt = os.path.exists(native._LIBPATH)
    if native.lib() is None:
        raise AssertionError("the port's native C++ library did not build "
                             "(ParILU's pair lists need it at this size)")
    say("build_native", seconds=time.perf_counter() - t0,
        library=native._LIBPATH, found_built=prebuilt)
    say("stream", copy_GBps=stream_gbps())

    t0 = time.perf_counter()
    Ab = gtt.Csr.from_data(stencil_3d(BANDED_NX, points=27),
                           dtype=np.float32)
    torch.cuda.synchronize()
    setup_banded = time.perf_counter() - t0
    say("setup_banded", seconds=setup_banded, strategy=Ab.strategy,
        n=Ab.shape[0], nnz=Ab.nnz, band_meta=dict(Ab.band_meta or ()))
    t0 = time.perf_counter()
    Ap = gtt.Csr.from_data(permute_locally(stencil_3d(*PACKED_DIMS,
                                                      points=27)),
                           dtype=np.float32)
    torch.cuda.synchronize()
    setup_packed = time.perf_counter() - t0
    say("setup_packed", seconds=setup_packed, strategy=Ap.strategy,
        n=Ap.shape[0], nnz=Ap.nnz, pell_meta=dict(Ap.pell_meta or ()),
        tail=Ap.tail_rows is not None)
    assert Ab.strategy == "banded" and Ap.strategy == "packed"

    t0 = time.perf_counter()
    Ai = gtt.Csr.from_data(build_matrix_data(ILU_CASE), dtype=np.float32)
    torch.cuda.synchronize()
    say("setup_ilu", case=ILU_CASE, seconds=time.perf_counter() - t0,
        strategy=Ai.strategy, n=Ai.shape[0], nnz=Ai.nnz,
        pell_meta=dict(Ai.pell_meta or ()), tail=Ai.tail_rows is not None)
    t0 = time.perf_counter()
    F = ParIlu(iterations=5).generate(Ai)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    M = Ilu(factorization=F).generate(Ai)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    say("ilu_generate", seconds=t2 - t0, factorization_s=t1 - t0,
        trisolve_generate_s=t2 - t1, l_nnz=F.l_factor.nnz,
        u_nnz=F.u_factor.nnz, l_algorithm=M.l_solver.algorithm,
        u_algorithm=M.u_solver.algorithm,
        l_meta=dict(M.l_solver.tri_meta or ()),
        u_meta=dict(M.u_solver.tri_meta or ()))
    assert Ai.strategy == "packed"
    assert M.l_solver.algorithm == M.u_solver.algorithm == "exact_packed"

    Ft, Mt, plan, ilut_launches = ilut_generate(Ai)
    onehot_launches = ilut_generate_onehot(Ai, Ft, plan)

    kernels = [phase_kernel_a(Ab), phase_kernel_b(Ap),
               phase_kernel_c(M.l_solver, F.l_factor),
               *phase_kernels_de(plan)]
    del plan

    ilu_launches, ilu_iters, bare_iters = main_ilu(Ai, M)
    runs = [main_path("banded", Ab, "banded", "dia_spmv"),
            main_path("packed", Ap, "packed", "pell_spmv"),
            ilu_launches, ilut_launches,
            main_ilut(Ai, Mt, ilu_iters, bare_iters), onehot_launches]
    for k in kernels:
        k["launches"] = sum(run[k["name"]] for run in runs)
    small_solves_match_cpu()
    small_ilu_solves_match_cpu()
    small_ilut_match_cpu()

    print(json.dumps({"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}
        for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
