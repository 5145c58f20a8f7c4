"""The traced window: ``torch.profiler`` over a few steady solves, read from
its Chrome trace.

* busy: the union of the device's kernels, copies and sets inside the
  window (first ``solve`` span's start to the last one's end);
* ``device_ops``: device time by kernel name, the largest first;
* ``idle_gaps``: the seconds in which the device ran nothing, summed by
  what the host was doing when each gap began: the benchmark's own span
  (``rhs``, ``solve``) and the innermost operator open on the host, if any.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
TOP = 10


def traced_solves(solve_one, min_solves: int, min_seconds: float,
                  cuda: bool = True):
    """Run ``solve_one(j)``, which returns its seconds and opens the
    ``rhs`` and ``solve`` spans itself, under the profiler until both
    floors are met; returns the parsed summary (see :func:`summarize`)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        j, spent = 0, 0.0
        while j < min_solves or spent < min_seconds:
            spent += solve_one(j)
            j += 1
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events) -> dict:
    """busy_s, window_s, device_ops and idle_gaps of a Chrome trace's
    events (times in microseconds)."""
    spans, device, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", "")).lower()
        start, dur = float(ev["ts"]), float(ev["dur"])
        if cat in DEVICE_CATS:
            device.append((start, start + dur, ev.get("name", "?")))
        elif cat == "user_annotation" and ev.get("name") in ("solve", "rhs"):
            spans.append((start, start + dur, ev["name"]))
        elif cat == "cpu_op":
            host.append((start, start + dur, ev.get("name", "?")))
    solves = [s for s in spans if s[2] == "solve"]
    if not solves:
        return {}
    w0, w1 = min(s[0] for s in solves), max(s[1] for s in solves)
    by_name = defaultdict(float)
    inside = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_name[name] += (e - s) * 1e-6
            inside.append((s, e))
    busy = _merge(inside)
    host.sort()
    host_starts = [h[0] for h in host]
    spans.sort()
    span_starts = [s[0] for s in spans]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            gaps[_label(g0, spans, span_starts, host, host_starts)] += \
                (g1 - g0) * 1e-6
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": sorted(([n[:160], t] for n, t in by_name.items()),
                             key=lambda p: -p[1])[:TOP],
        "idle_gaps": sorted(([n, t] for n, t in gaps.items()),
                            key=lambda p: -p[1])[:TOP],
    }


def _innermost(t, items, starts, depth=256):
    """The latest-started item of (start, end, name) open at time t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - depth, -1), -1):
        if items[j][1] > t:
            return items[j][2]
    return None


def _label(t, spans, span_starts, host, host_starts) -> str:
    span = _innermost(t, spans, span_starts) or "between"
    op = _innermost(t, host, host_starts)
    return f"{span}/{op}" if op else span
