#!/usr/bin/env python3
"""Probe where the time of the port's ParILUT path goes, on a CUDA card.

    python3 tools/torch_parilut_probe.py

On the f32 FEM system of ``chip_smoke.py`` (``build_matrix_data({"fem":
262144, "offscale": 1.2})``, packed layout), b = ones:

1. ``ParIlut(iterations=5).generate`` once, with the host planning split
   into its stages (closure, pair-count estimate, native pair emission,
   the product and denominator pair planners) and the stagetimer's
   transfer/device split;
2. a second generate on the same pattern (the plan is cached, so no
   planning), profiled with ``torch.profiler``: device time by kernel,
   the host time, and the device's busy share;
3. one Ilu(ParIlut)-BiCGSTAB solve to ``ResidualNorm(1e-5)``, profiled
   the same way, per iteration.

Prints one JSON object per line, the card's name and power limit first;
imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import ginkgo_tpu_torch as gtt  # noqa: E402
from ginkgo_tpu_torch import native  # noqa: E402
from ginkgo_tpu_torch.benchmark import build_matrix_data  # noqa: E402
from ginkgo_tpu_torch.factorization import ParIlut  # noqa: E402
from ginkgo_tpu_torch.factorization import par_ilut_packed as pk  # noqa: E402
from ginkgo_tpu_torch.ops import pair_contract  # noqa: E402
from ginkgo_tpu_torch.preconditioner import Ilu  # noqa: E402
from ginkgo_tpu_torch.solver import Bicgstab  # noqa: E402
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm  # noqa: E402
from ginkgo_tpu_torch.utils import stagetimer  # noqa: E402

CASE = {"fem": 262144, "offscale": 1.2}


def timed(stages, name, fn):
    """``fn`` with its wall seconds added to ``stages[name]``."""
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
    return wrapper


def profiled(fn):
    """(result, host seconds, device rows) of ``fn()`` under the profiler;
    rows are (device us, kernel name, launches), kernels only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  acc_events=True) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    return out, host_s, rows


def report(probe, host_s, rows, per=1, **fields):
    busy_us = sum(r[0] for r in rows)
    print(json.dumps({
        "probe": probe, **fields, "host_ms": host_s * 1e3 / per,
        "device_ms": busy_us / 1e3 / per,
        "device_busy_share": busy_us / 1e6 / host_s,
        "top_kernels_us": [[key[:80], round(us / per, 2), count]
                           for us, key, count in rows[:14]]}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_parilut_probe: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    A = gtt.Csr.from_data(build_matrix_data(CASE), dtype=np.float32)
    assert A.strategy == "packed", A.strategy
    plan_stages = {}
    for mod, name, key in (
            (pk, "_closure", "closure"),
            (pk, "_estimate_ilut_pairs", "pair_estimate"),
            (native, "ilut_pairs_rowmajor_native", "pair_emission"),
            (pair_contract, "plan_pair_contract", "pair_planner")):
        setattr(mod, name, timed(plan_stages, key, getattr(mod, name)))
    with stagetimer.collect() as st:
        t0 = time.perf_counter()
        ParIlut(iterations=5).generate(A)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    print(json.dumps({"probe": "generate_first", "seconds": seconds,
                      "planning_stages_s": plan_stages,
                      "stages_s": st.stages}), flush=True)
    F, host_s, rows = profiled(lambda: ParIlut(iterations=5).generate(A))
    report("generate_cached_plan", host_s, rows,
           contract_launches=42)
    M = Ilu(factorization=F).generate(A)
    b = torch.ones(A.shape[0], dtype=torch.float32, device="cuda")
    crit = Iteration(1000) | ResidualNorm(1e-5)
    Bicgstab.solve(A, b, criteria=crit, preconditioner=M)     # warm-up
    res, host_s, rows = profiled(lambda: Bicgstab.solve(
        A, b, criteria=crit, preconditioner=M))
    iters = int(res.iterations[0])
    report("ilut_bicgstab", host_s, rows, per=iters, iterations=iters,
           per_iteration=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
