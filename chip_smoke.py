#!/usr/bin/env python3
"""On-card smoke test of ``ginkgo_tpu_torch``, the PyTorch/CUDA port.

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

1. card: name and power limit (``nvidia-smi``); exits 2 without CUDA;
2. build: compiles every hand-written kernel of ``ops/csrc`` with ``nvcc``
   (one process per source, all started together);
3. kernel A (banded SpMV) against its plain PyTorch version on the card:
   small random banded matrices with k in {1, 3, 8, 9} in f32, f64 and
   bf16/f16 storage, and the 27-point stencil at nx=160 with k=1, timed
   beside its byte bound, its plain version and cuSPARSE;
4. kernel B (packed windowed-ELL SpMV), the same on small matrices and on
   the locally permuted 1,048,576-row stencil;
5. main path, banded: ``Csr.from_data`` of the nx=160 stencil on the card
   (``banded`` layout), Jacobi-CG to the tolerance below, with kernel A's
   launch count and the true residual recomputed independently;
6. main path, packed: the same on the permuted matrix (``packed`` layout);
7. small f64 solves on the card agree with the port's CPU run.

The line before the last is a JSON object with every kernel's launches on
the main path, error against its plain version, time, plain time, bound
and cuSPARSE time; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import ginkgo_tpu_torch as gtt
from ginkgo_tpu_torch.ops import _cuda, spmv_banded, spmv_packed
from ginkgo_tpu_torch.ops.spmv import coo_spmv
from ginkgo_tpu_torch.preconditioner import Jacobi
from ginkgo_tpu_torch.solver import Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import (permute_locally,
                                               stencil_3d)

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


# -- main path ----------------------------------------------------------------
COUNTERS = {"dia_spmv": spmv_banded.dia_spmv_cuda,
            "pell_spmv": spmv_packed.pell_spmv_cuda}


def main_path(label, A, strategy, kernel):
    """Jacobi-CG on ``A`` through the port's entry points; returns every
    kernel's launches during the solve."""
    assert A.strategy == strategy, (label, A.strategy)
    n = A.shape[0]
    b = torch.ones(n, dtype=torch.float32, device=DEV)
    torch.cuda.synchronize()
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = Cg.solve(A, b, criteria=Iteration(2000) | ResidualNorm(SOLVE_TOL),
                   preconditioner=Jacobi())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    # true residual, recomputed in f64 on the card by the plain COO product
    x = res.x.double()
    r = b.double() - coo_spmv(A.row_idx, A.col_idx, A.values, x[:, None],
                              n)[:, 0]
    true_rel = float(r.norm() / b.double().norm())
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

    kernels = [phase_kernel_a(Ab), phase_kernel_b(Ap)]

    launches = main_path("banded", Ab, "banded", "dia_spmv")
    more = main_path("packed", Ap, "packed", "pell_spmv")
    for k in kernels:
        k["launches"] = launches[k["name"]] + more[k["name"]]
    small_solves_match_cpu()

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
