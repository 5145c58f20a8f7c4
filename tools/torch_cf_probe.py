#!/usr/bin/env python3
"""Time kernels C (``ops/csrc/tri_packed.cu``) and F (``row_write.cu``)
against another version of their sources.

    python3 tools/torch_cf_probe.py [--old DIR] [--rounds 5] [--skip-c]
                                    [--skip-f] [--skip-gmres]

``--old DIR`` names the ``ops/csrc`` directory of another checkout (for
example the parent commit unpacked with ``git archive``): its
``tri_packed.cu`` and ``row_write.cu`` are built with the package's nvcc
flags and called through the same C entry points on the same tensors.

Kernel C: the L and U factors of ``Ilu(ParIlu(5))`` on the ILU system's
FEM matrix (``chip_smoke.ILU_CASE``), k = 1; both versions are held
against the plain version, then timed in turns (the order swapped each
round) with CUDA events queued behind a spinning kernel, and the host
time of enqueuing a launch through the C entry is taken the same way.
Prints the plan's P, Wv, nb, its chain depth, the launch's cluster and
ring, and the cycles between the phase boundaries of a step from the
``GTS_TRI_TRACE`` build (clock reads only; it solves like the kernel).

Kernel F: a row written by the kernel, by the old source and by
``copy_``, in turns: an f32 row of n = 4,096,000 (16-byte aligned alike:
the TMA ring) and one of n = 4,096,001 into rows that are not aligned
like the row (the scalar copy), each rotating over more than L2 (as
``chip_smoke.phase_kernel_f``); each writer is first checked bit for bit
against ``copy_``.  Then the host time of enqueuing one write of 4,096
elements through each C entry, and, unless ``--skip-gmres``, the host ms
an iteration of GMRES(100) and CB-GMRES ``reduce1`` on the nx=160
stencil (``chip_smoke.main_gmres``'s solves) with the package's row
writes routed through the kernel and through the old source, in turns.

Prints the card's ``nvidia-smi`` name and power limit and one JSON
object a measurement; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
import ginkgo_tpu_torch as gtt  # noqa: E402
from ginkgo_tpu_torch.benchmark import build_matrix_data  # noqa: E402
from ginkgo_tpu_torch.factorization import ParIlu  # noqa: E402
from ginkgo_tpu_torch.ops import _cuda, tri_packed  # noqa: E402
from ginkgo_tpu_torch.preconditioner import Ilu  # noqa: E402
from ginkgo_tpu_torch.solver import CbGmres  # noqa: E402
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm  # noqa: E402
from ginkgo_tpu_torch.utils.generators import stencil_3d  # noqa: E402


def build_other(src: Path, name: str, defines=()):
    """The library of another version (or build) of ``name``.cu, bound
    like ours."""
    out = REPO / "build" / "cf_probe"
    out.mkdir(parents=True, exist_ok=True)
    flags = [f"-D{d}" for d in defines]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    lib = out / f"lib{name}-other-{digest}.so"
    if not lib.exists():
        done = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags,
                               "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{done.stderr}")
    dll = ctypes.CDLL(str(lib))
    (entry, argtypes), = _cuda.SIGNATURES[name].items()
    fn = getattr(dll, entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn, dll


def in_turns(fns: dict, rounds: int, measure):
    """``measure(fn)`` of each function once a round, the order reversed
    every other round; returns {name: [one value a round]}."""
    turns = {name: [] for name in fns}
    for rnd in range(rounds):
        for name in sorted(fns, reverse=bool(rnd % 2)):
            turns[name].append(measure(fns[name]))
    return turns


def host_us(fn, reps):
    """Host µs a call of ``fn`` while the card spins, so no call waits on
    the card: what a launch costs the host."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(cs.QUEUE_AHEAD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def medians(turns):
    return {name: statistics.median(t) for name, t in turns.items()}


def raw_launch(fn, arrays, meta, b, x):
    """Launch a build of kernel C through its C entry point."""
    args = (_cuda.type_code(torch.float32), arrays["inv"].data_ptr(),
            arrays["crossi"].data_ptr(), arrays["crossv"].data_ptr(),
            arrays["nwv"].data_ptr(), meta["nb"], meta["P"], meta["Wv"],
            meta["n"], int(meta["flip"]), b.data_ptr(), b.shape[1],
            x.data_ptr(), x.shape[1], b.shape[1])

    def run():
        _cuda.check("tri_packed", fn(
            *args, torch.cuda.current_stream().cuda_stream))
    return run


TRACE_POINTS = ("top", "x_ready", "stage", "cross", "rhs_exchanged",
                "product", "out")


def trace_c(src, arrays, meta, b, want):
    """Cycles between the phase boundaries of a step (CTA 0, thread 0,
    steps 64 .. 127, median) from the ``GTS_TRI_TRACE`` build, whose
    solve is held against the plain version too."""
    fn, dll = build_other(src, "tri_packed", ("GTS_TRI_TRACE",))
    x = torch.empty_like(b)
    raw_launch(fn, arrays, meta, b, x)()
    torch.cuda.synchronize()
    err = cs.rel_err(x, want)[0]
    if err > cs.TOL[torch.float32]:
        raise AssertionError(f"the traced build of kernel C disagrees: {err}")
    out = (ctypes.c_longlong * (64 * 8))()
    get = getattr(dll, "tri_packed_trace")
    get.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    _cuda.check("tri_packed", get(out))
    tr = np.array(out, dtype=np.int64).reshape(64, 8)[:, :len(TRACE_POINTS)]
    seg = {f"{a}->{b}": float(np.median(tr[:, j + 1] - tr[:, j]))
           for j, (a, b) in enumerate(zip(TRACE_POINTS, TRACE_POINTS[1:]))}
    seg["step"] = float(np.median(tr[1:, 0] - tr[:-1, 0]))
    return seg


def probe_c(old, rounds):
    A = gtt.Csr.from_data(build_matrix_data(cs.ILU_CASE), dtype=np.float32)
    M = Ilu(factorization=ParIlu(iterations=5).generate(A)).generate(A)
    new = _cuda.library("tri_packed").tri_packed_launch
    for label, op in (("l", M.l_solver), ("u", M.u_solver)):
        arrays, meta_items = op.pk_arrays, op.tri_meta
        meta = dict(meta_items)
        b = torch.randn((meta["n"], 1), dtype=torch.float32, device=cs.DEV)
        want = tri_packed.packed_trisolve_reference(arrays, meta_items, b)
        fns, errs = {}, {}
        for name, fn in (("new", new), ("old", old)):
            if fn is None:
                continue
            x = torch.empty_like(b)
            fns[name] = raw_launch(fn, arrays, meta, b, x)
            fns[name]()
            errs[name] = cs.rel_err(x, want)[0]
        if max(errs.values()) > cs.TOL[torch.float32]:
            raise AssertionError(f"kernel C ({label}) disagrees: {errs}")
        cycles = trace_c(_cuda.SRC_DIR / "tri_packed.cu", arrays, meta, b,
                         want)
        turns = in_turns(fns, rounds,
                         lambda fn: cs.time_ms(fn, 10, queue_ahead=True))
        host = in_turns(fns, rounds, lambda fn: host_us(fn, 10))
        med = medians(turns)
        cs.say("probe_c", factor=label, P=meta["P"], Wv=meta["Wv"],
               nb=meta["nb"], **cs.tri_chain(arrays, meta_items),
               config=tri_packed.packed_trisolve_config(meta_items, 1),
               ms=med, ms_per_block={name: t / meta["nb"]
                                     for name, t in med.items()},
               ms_turns=turns, host_us=medians(host), host_us_turns=host,
               max_rel_err=errs, step_cycles=cycles)


def c_writer(fn):
    """``store[i] = row`` through a build's ``row_write_launch``."""
    def write(store, i, row):
        n_row = row.numel()
        _cuda.check("row_write", fn(
            store.data_ptr() + i * n_row * store.element_size(),
            row.data_ptr(), n_row, store.element_size(),
            torch.cuda.current_stream().cuda_stream))
    return write


def time_rows(writers, n, rows, misalign, rounds):
    """Writers in turns on f32 rows of ``n`` rotating over ``rows`` of an
    (8, n) store and 4 sources; with ``misalign`` every source starts 16
    bytes aligned and every destination row does not."""
    store = torch.zeros((8, n), device=cs.DEV)
    srcs = torch.randn((4, -(-n // 4) * 4), device=cs.DEV)[:, :n]
    if misalign:
        assert all((store[i].data_ptr() - srcs[0].data_ptr()) % 16
                   for i in rows)
    turn = iter(range(1 << 30))

    def rotating(write):
        def launch():
            j = next(turn)
            write(store, rows[j % len(rows)], srcs[j % 4])
        return launch

    turns = in_turns({name: rotating(w) for name, w in writers.items()},
                     rounds, lambda fn: cs.time_ms(fn, 20, queue_ahead=True))
    med = medians(turns)
    bms, _ = cs.bound(2 * n * 4, 0)
    cs.say("probe_f", n=n, misaligned=misalign, bound_ms=bms, ms=med,
           ms_turns=turns,
           vs_copy={name: t / med["copy_"] for name, t in med.items()})


@contextlib.contextmanager
def row_writes_through(fn):
    """Within the block, the package's row writes (``row_write_cuda``)
    launch through ``fn``, another build's ``row_write_launch``."""
    real = _cuda.library
    ours = types.SimpleNamespace(
        row_write_launch=fn,
        row_write_error_string=real("row_write").row_write_error_string)

    def library(name):
        return ours if name == "row_write" else real(name)

    _cuda.library = library
    try:
        yield
    finally:
        _cuda.library = real


def probe_gmres(new, old, rounds):
    """Host ms an iteration of the GMRES main-path solves with kernel F
    from ``new`` and from ``old``, in turns."""
    A = gtt.Csr.from_data(stencil_3d(cs.BANDED_NX, points=27),
                          dtype=np.float32)
    b = torch.ones(A.shape[0], dtype=torch.float32, device=cs.DEV)

    for storage in ("keep", "reduce1"):
        iters = {}

        def solve(named):
            name, fn = named
            with row_writes_through(fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = CbGmres.solve(
                    A, b, criteria=Iteration(1000) | ResidualNorm(
                        cs.GMRES_TOL, baseline="rhs_norm"),
                    krylov_dim=cs.GMRES_KRYLOV_DIM, ortho="cgs2",
                    storage_precision=storage)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            it = int(res.iterations[0])
            iters.setdefault(name, set()).add(it)
            return seconds * 1e3 / it

        fns = {"kernel": ("kernel", new), "old": ("old", old)}
        for named in fns.values():
            solve(named)    # warm-up
        turns = in_turns(fns, rounds, solve)
        cs.say("probe_gmres", storage=storage,
               iterations={name: sorted(it) for name, it in iters.items()},
               ms_per_iteration=medians(turns), ms_turns=turns)


def probe_f(old, rounds, skip_gmres):
    new = _cuda.library("row_write").row_write_launch
    writers = {"kernel": c_writer(new),
               "copy_": lambda s, i, r: s[i].copy_(r)}
    if old is not None:
        writers["old"] = c_writer(old)
    # bit for bit copy_ on ragged, misaligned and full-size rows
    for m in (1003, 3 * 16384 + 5, 4_096_000):
        for off in (0, 1, 3):
            src = torch.randn(m + off, device=cs.DEV)[off:]
            for name, write in writers.items():
                store = torch.zeros((3, m), device=cs.DEV)
                write(store, 1, src)
                if not torch.equal(store[1], src) or bool(store[0].any()):
                    raise AssertionError(f"{name} differs from copy_ at "
                                         f"n={m}, offset {off}")
    time_rows(writers, 4_096_000, range(1, 8), False, rounds)
    time_rows(writers, 4_096_001, (1, 2, 3, 5, 6, 7), True, rounds)

    store = torch.zeros((2, 4096), device=cs.DEV)
    row = torch.randn(4096, device=cs.DEV)
    c_only = {name: w for name, w in writers.items() if name != "copy_"}
    host = in_turns({name: (lambda w=w: w(store, 1, row))
                     for name, w in c_only.items()}, rounds,
                    lambda fn: host_us(fn, 400))
    cs.say("probe_f_host", n=4096, host_us=medians(host), host_us_turns=host)
    if old is not None and not skip_gmres:
        probe_gmres(new, old, max(3, rounds // 2 + 1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--skip-c", action="store_true")
    ap.add_argument("--skip-f", action="store_true")
    ap.add_argument("--skip-gmres", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cf_probe: needs a CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    _cuda.build(("tri_packed", "row_write"))
    old_c = old_f = None
    if args.old is not None:
        old_c, _ = build_other(args.old / "tri_packed.cu", "tri_packed")
        old_f, _ = build_other(args.old / "row_write.cu", "row_write")
    if not args.skip_f:
        probe_f(old_f, args.rounds, args.skip_gmres)
    if not args.skip_c:
        probe_c(old_c, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
