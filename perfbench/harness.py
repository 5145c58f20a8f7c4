"""One run of one cell: set-up, warm-up, the measured window, the metrics,
then the check of the window's answers against the plain reference.

The window is a closed loop of solves with one operator: solve ``i`` gets
the right-hand side block ``i`` of the seed, x0 = 0, and ends in a device
synchronisation; the next starts when it returns.  No solve starts once
``seconds`` have passed, so the window ends with the last solve's return.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
import traceback

import torch

from . import check, profile, spec
from .rhs import RhsStream

TRACE_MIN_SOLVES = 2
TRACE_MIN_SECONDS = 0.5


@dataclasses.dataclass
class SolveRecord:
    start: float
    end: float
    iterations: int     # the most any column took
    ok: bool            # returned, converged and did not stagnate


@dataclasses.dataclass
class Run:
    """What the metric readers (``metrics/<name>.py``) read."""

    cell: spec.Cell
    device: torch.device
    setup_s: float
    window_s: float
    solves: list
    spans: dict
    peak_bytes: int
    trace: dict | None = None
    system: object | None = None     # live until the readers are done
    peaks: dict | None = None        # this card's row of peaks.json


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _device_info(device, cell, peak_bytes):
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type,
                "count": cell.chips, "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell.chips, "memory_peak_bytes": peak_bytes,
            "power_limit_w": _power_limit_w()}


def run_cell(root, name: str, seed: int, seconds: float, trace: bool,
             device, t0: float, log=sys.stderr) -> dict:
    """The result line's object of one run; ``t0`` is the process's start
    on ``time.perf_counter``'s clock."""
    device = torch.device(device)
    spans = {"start": time.perf_counter() - t0}
    cell = spec.load_cell(root, name)
    config = cell.config
    t = time.perf_counter()
    matrix = cell.module("matrices").generate(config)
    spans["generate"] = time.perf_counter() - t
    system = cell.module("systems").System(matrix, config, device, spans)
    stream = RhsStream(cell.traffic, system.n, seed, device,
                       getattr(torch, config["dtype"]))

    t = time.perf_counter()
    system.solve(stream.rhs(-1))
    _sync(device)
    spans["warmup"] = time.perf_counter() - t

    solves, kept = [], check.Reservoir(int(cell.check["sample"]), seed)
    w0 = time.perf_counter()
    setup_s = w0 - t0
    i = 0
    while i == 0 or time.perf_counter() - w0 < seconds:
        b = stream.rhs(i)
        start = time.perf_counter()
        try:
            res = system.solve(b)
            _sync(device)
        except Exception:  # a failed solve is counted, and the window goes on
            solves.append(SolveRecord(start, time.perf_counter(), 0, False))
            if sum(not s.ok for s in solves) == 1:
                traceback.print_exc(file=log)
        else:
            end = time.perf_counter()
            solves.append(SolveRecord(start, end, int(res.iterations.max()),
                                      check.solve_ok(res)))
            kept.offer(i, (res.x, res.iterations))
            del res
        i += 1
    window_s = solves[-1].end - w0
    _log_window(log, setup_s, spans, window_s, solves)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    run = Run(cell=cell, device=device, setup_s=setup_s, window_s=window_s,
              solves=solves, spans=spans, peak_bytes=peak, system=system,
              peaks=_peaks(cell, device))
    if trace:
        from torch.profiler import record_function

        def solve_one(j):
            with record_function("rhs"):
                b = stream.rhs(i + j)
            with record_function("solve"):
                start = time.perf_counter()
                system.solve(b)
                _sync(device)
                return time.perf_counter() - start

        run.trace = profile.traced_solves(solve_one, TRACE_MIN_SOLVES,
                                          TRACE_MIN_SECONDS,
                                          cuda=device.type == "cuda")
    wanted = cell.trace_metrics if trace else cell.metrics
    metrics = {}
    for mname, entry in wanted.items():
        value = cell.reader(mname)(run)
        if value is not None:
            metrics[mname] = {"value": value, "unit": entry["unit"]}

    # free the program's state before the reference runs
    run.system = system = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = cell.module("reference")
    op = reference.operator(matrix, device)
    failed = sum(not s.ok for s in solves)
    rows = check.compare(reference, op, config, cell.check, kept.items,
                         stream.rhs, failed)
    result = {"correct": check.verdict(rows), "attempted": len(solves),
              "failed": failed, "metrics": metrics,
              "device": _device_info(device, cell, peak)}
    if trace and run.trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = {n: {"value": _finite(v), "limit": lim}
                        for n, v, lim in rows}
    return result


def _log_window(log, setup_s, spans, window_s, solves):
    """Where set-up went and how the window's solves spread, for the
    record; the result line keeps only the metrics."""
    times = sorted(1e3 * (s.end - s.start) for s in solves)
    half = len(solves) // 2
    halves = [1e3 * (part[-1].end - part[0].start) / len(part)
              for part in (solves[:half], solves[half:]) if part]
    print(f"set-up {setup_s:.3f} s (" + ", ".join(
        f"{k} {v:.3f}" for k, v in spans.items()) + f"); window "
          f"{window_s:.3f} s, {len(solves)} solves, iterations "
          f"{sum(s.iterations for s in solves) / len(solves):.2f}, solve ms "
          f"min {times[0]:.2f} median {times[len(times) // 2]:.2f} max "
          f"{times[-1]:.2f}, halves " + " ".join(f"{h:.2f}" for h in halves),
          file=log, flush=True)


def _finite(v):
    return v if v == v and abs(v) != float("inf") else None


def _peaks(cell, device):
    if device.type != "cuda":
        return None
    with open(cell.dir / "peaks.json") as fh:
        return json.load(fh).get(torch.cuda.get_device_name(device))


def check_lines(result: dict) -> list[str]:
    """The compared numbers beside their limits, for standard error."""
    return [f"check {n}: {c['value']} (limit {c['limit']})"
            for n, c in result["checks"].items()] + [
        f"correct: {result['correct']}"]
