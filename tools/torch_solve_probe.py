#!/usr/bin/env python3
"""Probe the port's main-path Jacobi-CG solves on a CUDA card.

    python3 tools/torch_solve_probe.py [banded] [packed]

For the two systems of ``chip_smoke.py`` (the 27-point stencil at nx=160,
banded layout, and the locally permuted 256x64x64 stencil, packed layout),
or those named on the command line, both in f32 with b = ones:

1. solve at each ResidualNorm tolerance of ``TOLS`` and print iterations,
   converged / stagnated and the true relative residual recomputed in f64,
   which shows the lowest tolerance an f32 solve can meet;
2. profile one solve of 50 CG iterations (the preconditioner generated
   beforehand) with ``torch.profiler`` and print the device time per
   iteration by kernel, the host time per iteration and the device's busy
   share of it; the window holds 52 SpMVs: the initial residual, 50
   iterations and the final true-residual audit.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object per line; imports nothing of JAX.
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
from ginkgo_tpu_torch.ops.spmv import coo_spmv  # noqa: E402
from ginkgo_tpu_torch.preconditioner import Jacobi  # noqa: E402
from ginkgo_tpu_torch.solver import Cg  # noqa: E402
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm  # noqa: E402
from ginkgo_tpu_torch.utils.generators import (permute_locally,  # noqa: E402
                                               stencil_3d)

TOLS = (1e-3, 5e-4, 3e-4, 2e-4, 1e-4, 5e-5, 2e-5, 1e-5)
PROFILE_ITERS = 50


def true_residual(A, x, b):
    r = b.double() - coo_spmv(A.row_idx, A.col_idx, A.values,
                              x.double()[:, None], A.shape[0])[:, 0]
    return float(r.norm() / b.double().norm())


def sweep(label, A, b):
    for tol in TOLS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = Cg.solve(A, b, criteria=Iteration(2000) | ResidualNorm(tol),
                       preconditioner=Jacobi())
        torch.cuda.synchronize()
        print(json.dumps({
            "probe": "tolerance", "system": label, "tol": tol,
            "iterations": int(res.iterations[0]),
            "converged": bool(res.converged[0]),
            "stagnated": bool(res.stagnated[0]),
            "true_rel_residual": true_residual(A, res.x, b),
            "solve_s": time.perf_counter() - t0}), flush=True)


def profile(label, A, b):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    crit = Iteration(PROFILE_ITERS)       # a fixed number of iterations
    M = Jacobi().generate(A)              # generated outside the window
    Cg.solve(A, b, criteria=Iteration(3), preconditioner=M)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA],
                  acc_events=True) as prof:
        t0 = time.perf_counter()
        Cg.solve(A, b, criteria=crit, preconditioner=M)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    # kernels only: an operator's row repeats the time of its kernels
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(json.dumps({
        "probe": "profile", "system": label, "iterations": PROFILE_ITERS,
        "host_ms_per_iteration": host_s * 1e3 / PROFILE_ITERS,
        "device_ms_per_iteration": busy_us / 1e3 / PROFILE_ITERS,
        "device_busy_share": busy_us / 1e6 / host_s,
        "top_kernels_us_per_iteration": [
            [key[:80], round(us / PROFILE_ITERS, 2), count]
            for us, key, count in rows[:12]]}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_solve_probe: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    systems = {"banded": lambda: stencil_3d(160, points=27),
               "packed": lambda: permute_locally(
                   stencil_3d(256, 64, 64, points=27))}
    for label in sys.argv[1:] or systems:
        make = systems[label]
        A = gtt.Csr.from_data(make(), dtype=np.float32)
        b = torch.ones(A.shape[0], dtype=torch.float32, device="cuda")
        sweep(label, A, b)
        profile(label, A, b)
        del A
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
