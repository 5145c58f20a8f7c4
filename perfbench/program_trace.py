"""The program's own spans and counters over a few solves after the window,
joined to a device trace: what the readers of the solver loop, the
preconditioner and the Krylov basis read (``ops_per_iter``,
``host_reads_per_iter``, ``dispatch_ms_per_iter``, ``precond_ms_per_iter``,
``project_ms_per_iter`` and their ``.1rhs`` names).

Two passes over right-hand sides drawn from this file's own seed, each of
at least ``harness.TRACE_MIN_SOLVES`` solves and
``harness.TRACE_MIN_SECONDS`` seconds, both under the program's recording
(``ginkgo_tpu_torch.log.record``):

* the host pass, alone: the host's own time in an iteration and its host
  reads, with no profiler adding its cost to every op;
* the device pass, under ``torch.profiler`` too, so that the program's spans
  land in its Chrome trace (``user_annotation``) on the clock of the ops and
  the device events.  A device event (kernel, copy, set) is joined through
  its ``correlation`` to the runtime call that launched it and given to the
  innermost program span open at that launch.  On the CPU, where the
  device is the host, a span's device time is its own duration.

The device pass prints one line to standard error: the device time an
iteration by span, the busy time an iteration, and the traced window's
device idle time summed by the innermost program span open when each gap
began (``between`` outside any).  The summary is kept on the run, so the
readers share one pair of passes.  A program without the recording gives
None, and the readers leave their metrics out.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import torch

from . import harness
from .profile import DEVICE_CATS, _merge
from .rhs import RhsStream

SEED = 1_900_000_019     # right-hand sides apart from the window's
ITERATION = "loop.iteration"
HOST_READ = "loop.host_read"
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
_KEY = "_program_trace"


def summary(run):
    """``{"host": ..., "device": ...}`` of the run's program trace (see
    :func:`host_summary` and :func:`summarize`), or None."""
    if not hasattr(run, _KEY):
        setattr(run, _KEY, _trace(run))
    return getattr(run, _KEY)


def per_iter(run, part: str, key: str):
    """One number of the summary's ``part``, or None."""
    s = summary(run)
    return None if s is None else s[part].get(key)


def span_ms_per_iter(run, name: str):
    """Device milliseconds of the spans ``name`` over the device pass's
    iterations, or None where the pass had no such span."""
    s = summary(run)
    if s is None or name not in s["device"]["device_s"]:
        return None
    return 1e3 * s["device"]["device_s"][name] / s["device"]["iterations"]


def _trace(run):
    try:
        from ginkgo_tpu_torch.log import record
    except ImportError:
        return None
    system, device = run.system, run.device
    if system is None:
        return None
    cuda = device.type == "cuda"
    stream = RhsStream(run.cell.traffic, system.n, SEED, device,
                       getattr(torch, run.cell.config["dtype"]))

    def solves(offset):
        j, t0 = 0, time.perf_counter()
        while (j < harness.TRACE_MIN_SOLVES
               or time.perf_counter() - t0 < harness.TRACE_MIN_SECONDS):
            system.solve(stream.rhs(offset + j))
            if cuda:
                torch.cuda.synchronize(device)
            j += 1
        return j

    with record() as rec:
        solves(0)
    host = host_summary(rec.spans, rec.counters)

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof, record():
        n = solves(1000)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    dev = summarize(events, device_is_host=not cuda)
    if not host or not dev:
        return None
    print(f"program trace: {n} solves; " + idle_line(dev), file=sys.stderr,
          flush=True)
    return {"host": host, "device": dev}


def host_summary(spans, counters) -> dict:
    """From a recording: iterations, host reads an iteration, and the mean
    milliseconds of an iteration less its host reads (the host's own time:
    Python, dispatch, launches)."""
    spans = [s for s in spans if s.solve_id is not None]
    iters = [s for s in spans if s.name == ITERATION]
    if not iters:
        return {}
    reads = defaultdict(int)
    for s in spans:
        if s.name == HOST_READ and s.parent_id is not None:
            reads[s.parent_id] += s.t1_ns - s.t0_ns
    own = sum(s.t1_ns - s.t0_ns - reads[s.span_id] for s in iters)
    return {"iterations": len(iters),
            "host_reads_per_iter": counters.get("host_reads", 0) / len(iters),
            "dispatch_ms_per_iter": own * 1e-6 / len(iters)}


def _nested(items):
    """items sorted by (start, -end): the index of each one's parent (the
    innermost earlier item that contains its start), -1 for none."""
    parent, stack = [], []
    for i, (s, _, _) in enumerate(items):
        while stack and items[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return parent


def _innermost(t, items, starts, parent):
    """Index of the innermost item of (start, end, name) open at t, or
    -1."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and items[i][1] <= t:
        i = parent[i]
    return i


def summarize(events, device_is_host: bool = False) -> dict:
    """From a Chrome trace's events (times in microseconds): ``iterations``
    (``loop.iteration`` spans), ``ops_per_iter`` (top-level ``cpu_op``
    events that start inside them, over their number), ``device_s`` (device
    seconds by program span), and for a real device ``busy_s``,
    ``window_s`` (first ``solver.*`` span's start to the last one's end)
    and ``idle_s`` (the window's idle seconds by the innermost span open
    when each gap began)."""
    spans, ops, device, launches = [], defaultdict(list), [], {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", "")).lower()
        start, end = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        corr = ev.get("args", {}).get("correlation")
        if cat == "user_annotation":
            spans.append((start, end, ev["name"], ev.get("tid")))
        elif cat == "cpu_op":
            ops[ev.get("tid")].append((start, end))
        elif cat in DEVICE_CATS:
            device.append((start, end, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = start
    iters = sorted((s, e) for s, e, name, _ in spans if name == ITERATION)
    if not iters:
        return {}
    iter_tids = {tid for _, _, name, tid in spans if name == ITERATION}
    spans = sorted(((s, e, name) for s, e, name, _ in spans),
                   key=lambda x: (x[0], -x[1]))
    starts = [s for s, _, _ in spans]
    parent = _nested(spans)
    out = {"iterations": len(iters),
           "ops_per_iter": _ops_inside(ops, iter_tids, _merge(iters))
           / len(iters)}
    device_s = defaultdict(float)
    if device_is_host:
        for s, e, name in spans:
            device_s[name] += (e - s) * 1e-6
        out["device_s"] = dict(device_s)
        return out
    for s, e, corr in device:
        if corr in launches:
            i = _innermost(launches[corr], spans, starts, parent)
            device_s[spans[i][2] if i >= 0 else "between"] += (e - s) * 1e-6
    out["device_s"] = dict(device_s)
    solves = [(s, e) for s, e, name in spans
              if name.startswith("solver.")] or iters
    w0, w1 = min(s for s, _ in solves), max(e for _, e in solves)
    busy = _merge([(max(s, w0), min(e, w1)) for s, e, _ in device
                   if min(e, w1) > max(s, w0)])
    idle = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            i = _innermost(g0, spans, starts, parent)
            idle[spans[i][2] if i >= 0 else "between"] += (g1 - g0) * 1e-6
    out.update(busy_s=sum(e - s for s, e in busy) * 1e-6,
               window_s=(w1 - w0) * 1e-6, idle_s=dict(idle))
    return out


def _ops_inside(ops, tids, intervals) -> int:
    """Top-level ops (inside no other op of their thread) of the threads
    ``tids`` that start inside one of the sorted, disjoint ``intervals``."""
    starts = [s for s, _ in intervals]
    n = 0
    for tid in tids:
        open_end = float("-inf")
        for s, e in sorted(ops.get(tid, ()), key=lambda x: (x[0], -x[1])):
            if s < open_end:
                continue     # nested in the op still open
            open_end = e
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and s < intervals[i][1]
    return n


def idle_line(dev: dict) -> str:
    """The device pass's numbers for standard error."""
    iters = dev["iterations"]
    by_span = ", ".join(f"{k} {1e3 * v / iters:.4f}" for k, v in sorted(
        dev["device_s"].items(), key=lambda kv: -kv[1]))
    line = (f"{iters} iterations, {dev['ops_per_iter']:.2f} ops an "
            f"iteration; device ms an iteration by span: {by_span}")
    if "idle_s" in dev:
        idle = ", ".join(f"{k} {v:.6f}" for k, v in sorted(
            dev["idle_s"].items(), key=lambda kv: -kv[1]))
        line += (f"; busy ms an iteration {1e3 * dev['busy_s'] / iters:.4f}"
                 f", window {dev['window_s']:.6f} s; idle s by span: "
                 f"{idle}")
    return line
