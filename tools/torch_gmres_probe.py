#!/usr/bin/env python3
"""Probe the port's GMRES path on a CUDA card.

    python3 tools/torch_gmres_probe.py

On the system of ``chip_smoke.py``'s GMRES phases (the 27-point stencil at
nx=160, banded layout, f32, b = ones), for GMRES (``keep``) and CB-GMRES
(``reduce1``, ``integer``), all with krylov_dim 100 and CGS2:

1. the host time of one full cycle (``Iteration(100)``, 100 Arnoldi steps
   at j = 0..99) after a warm-up solve, without the profiler;
2. the same cycle under ``torch.profiler``, split into the SpMV (kernel
   A), the projection (the basis reads and their widening to f32, the dot
   and update products of CGS2; a ``record_function`` range around them),
   the basis write (kernel F) and the rest (norms, the Givens update, the
   solver's bookkeeping).  Prints the device ms per iteration of each
   part, the host ms per iteration and the device's busy share of it.

Prints the card's name and power limit, then one JSON object per line;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import ginkgo_tpu_torch as gtt  # noqa: E402
from ginkgo_tpu_torch.solver import CbGmres  # noqa: E402
from ginkgo_tpu_torch.solver import gmres as gmres_mod  # noqa: E402
from ginkgo_tpu_torch.solver import krylov_basis  # noqa: E402
from ginkgo_tpu_torch.stop import Iteration  # noqa: E402
from ginkgo_tpu_torch.utils.generators import stencil_3d  # noqa: E402

NX = 160
KRYLOV_DIM = 100
STORAGES = ("keep", "reduce1", "integer")


def solve(A, b, storage, iters):
    res = CbGmres.solve(A, b, criteria=Iteration(iters),
                        krylov_dim=KRYLOV_DIM, ortho="cgs2",
                        storage_precision=storage)
    torch.cuda.synchronize()
    return res


def annotated():
    """Put the projection's calls in a ``record_function`` range; returns
    the undo."""
    from torch.profiler import record_function

    def wrap(label, fn):
        def inner(*args, **kw):
            with record_function(f"gmres::{label}"):
                return fn(*args, **kw)
        return inner

    saved = [(gmres_mod, "_dots"), (gmres_mod, "_combine"),
             (krylov_basis.KrylovBasis, "read_block"),
             (krylov_basis.ScaledIntBasis, "read_block")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in saved]
    for obj, name, fn in saved:
        setattr(obj, name, wrap("projection", fn))

    def undo():
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    return undo


def profile(A, b, storage):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    solve(A, b, storage, 5)                       # warm-up
    t0 = time.perf_counter()
    solve(A, b, storage, KRYLOV_DIM)
    host_s = time.perf_counter() - t0
    undo = annotated()
    try:
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA],
                      acc_events=True) as prof:
            t0 = time.perf_counter()
            solve(A, b, storage, KRYLOV_DIM)
            profiled_s = time.perf_counter() - t0
    finally:
        undo()
    # kernels only: the ranges also show on the device timeline as spans
    # of their own, which would count their kernels twice
    kernels = [(ev.self_device_time_total, ev.key, ev.count)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0
               and not ev.key.startswith("gmres::")]
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    # the projection's kernels are launched by torch operators inside its
    # range, whose device time is theirs; kernels A and F are launched
    # through ctypes, outside any operator, so they are found by name
    parts = {"spmv": sum(k[0] for k in kernels if "dia_spmv" in k[1]),
             "projection": sum(ev.device_time_total for ev in prof.events()
                               if ev.name == "gmres::projection"
                               and ev.device_type == DeviceType.CPU),
             "row_write": sum(k[0] for k in kernels if "row_write" in k[1])}
    per = 1e3 * KRYLOV_DIM
    print(json.dumps({
        "probe": "gmres_cycle", "storage": storage, "n": A.shape[0],
        "iterations": KRYLOV_DIM,
        "host_ms_per_iteration": host_s * 1e3 / KRYLOV_DIM,
        "profiled_host_ms_per_iteration": profiled_s * 1e3 / KRYLOV_DIM,
        "device_ms_per_iteration": busy_us / per,
        "device_busy_share": busy_us / 1e6 / host_s,
        "device_ms_per_iteration_by_part": dict(
            {part: us / per for part, us in parts.items()},
            rest=(busy_us - sum(parts.values())) / per),
        "kernel_launches_per_iteration": sum(k[2] for k in kernels)
        / KRYLOV_DIM,
        "top_kernels_us_per_iteration": [
            [key[:80], round(us / KRYLOV_DIM, 2), count]
            for us, key, count in kernels[:12]]}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gmres_probe: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    A = gtt.Csr.from_data(stencil_3d(NX, points=27), dtype=np.float32)
    b = torch.ones(A.shape[0], dtype=torch.float32, device="cuda")
    for storage in STORAGES:
        profile(A, b, storage)
    return 0


if __name__ == "__main__":
    sys.exit(main())
