"""The port's tracer: named spans and counters on the profiler's clock, and
``ProfilerHook``'s summary of them (``ginkgo_tpu/log/profiler_hook.py`` in
torch).

Analog of ``include/ginkgo/core/log/profiler_hook.hpp:57`` (NVTX/ROCTX/TAU/
VTune range converters + ``create_summary:347``).  The library brackets its
layers with :func:`span` and counts with :func:`count`; both cost one test
of a module flag until something records (:func:`record`, or a captured
``ProfilerHook``).  While recording, a span is kept in memory with its
parent, its solve and its host times (``time.perf_counter_ns``, no sync);
on a CUDA machine it is an NVTX range, and while a ``torch.profiler`` runs
it is a ``torch.profiler.record_function`` range too, so it lands in the
trace on the clock of the device events.  (Outside a profiler the
``record_function`` would cost most of a span's time and show nowhere.)  Device time for a span
comes from a profiler trace taken around the recording, joined by the span
names.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import torch

from .logger import Logger

_active: Optional["Recording"] = None     # the recording in force
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    span_id: int
    parent_id: Optional[int]
    solve_id: Optional[int]     # the outermost ``solver.*`` span it is in
    name: str
    t0_ns: int
    t1_ns: int


class Recording:
    """What one :func:`record` scope saw: ``spans`` (in the order they
    closed) and ``counters`` (name -> total)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.nvtx = torch.cuda.is_available()
        self._open: list[_OpenSpan] = []
        self._next_id = 0


class _OpenSpan:
    __slots__ = ("rec", "name", "span_id", "parent_id", "solve_id", "t0",
                 "range")

    def __init__(self, rec: Recording, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        parent = rec._open[-1] if rec._open else None
        self.span_id = rec._next_id
        rec._next_id += 1
        self.parent_id = None if parent is None else parent.span_id
        self.solve_id = (parent.solve_id if parent is not None
                         else self.span_id if self.name.startswith("solver.")
                         else None)
        rec._open.append(self)
        if rec.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.range = (torch.profiler.record_function(self.name)
                      if torch.autograd._profiler_enabled() else _OFF)
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        self.range.__exit__(*exc)
        if rec.nvtx:
            torch.cuda.nvtx.range_pop()
        rec._open.pop()
        rec.spans.append(Span(self.span_id, self.parent_id, self.solve_id,
                              self.name, self.t0, t1))
        return False


def span(name: str):
    """A context manager bracketing one layer's work under ``name``; the
    shared null context when nothing records."""
    if _active is None:
        return _OFF
    return _OpenSpan(_active, name)


def count(name: str, n: int = 1):
    """Add ``n`` to the recording's counter ``name``; nothing when nothing
    records."""
    if _active is not None:
        counters = _active.counters
        counters[name] = counters.get(name, 0) + n


@contextlib.contextmanager
def record():
    """Record spans and counters for the extent of the scope; yields the
    :class:`Recording`.  An inner scope shadows an outer one for its
    extent."""
    global _active
    prev, _active = _active, Recording()
    try:
        yield _active
    finally:
        _active = prev


def _span_times(spans) -> dict:
    """{name: (count, inclusive_s, self_s)} over ``spans``; a span's self
    time is its duration less that of its child spans."""
    children = {}
    for s in spans:
        if s.parent_id is not None:
            children[s.parent_id] = (children.get(s.parent_id, 0)
                                     + s.t1_ns - s.t0_ns)
    out = {}
    for s in spans:
        dur = s.t1_ns - s.t0_ns
        cnt, inc, own = out.get(s.name, (0, 0.0, 0.0))
        out[s.name] = (cnt + 1, inc + dur * 1e-9,
                       own + (dur - children.get(s.span_id, 0)) * 1e-9)
    return out


class ProfilerHook(Logger):
    """Records spans and counters while captured (``capture(ProfilerHook())``
    or ``add_logger``) and summarises them by name.

    ``create_summary()`` -> {name: (count, inclusive_s, self_s)} in host
    seconds, with no sync (a span closes when the host leaves it, not when
    the card finishes its launches); ``write_summary()`` -> a markdown table
    (profiler_hook_summary_writer analog) followed by the counters.  It
    takes no logger event.
    """

    def __init__(self):
        super().__init__(events_mask=())
        self.recording: Optional[Recording] = None
        self._scope = None

    def attach(self):
        self._scope = record()
        self.recording = self._scope.__enter__()

    def detach(self):
        scope, self._scope = self._scope, None
        scope.__exit__(None, None, None)

    def create_summary(self):
        return _span_times(self.recording.spans if self.recording else ())

    def write_summary(self, stream=None) -> str:
        lines = ["| range | count | total [s] | self [s] | avg [s] |",
                 "|---|---|---|---|---|"]
        for name, (cnt, tot, own) in sorted(self.create_summary().items(),
                                            key=lambda kv: -kv[1][1]):
            lines.append(f"| {name} | {cnt} | {tot:.6f} | {own:.6f} | "
                         f"{tot / cnt:.6f} |")
        counters = self.recording.counters if self.recording else {}
        if counters:
            lines += ["", "| counter | count |", "|---|---|"]
            lines += [f"| {name} | {n} |"
                      for name, n in sorted(counters.items())]
        out = "\n".join(lines)
        if stream is not None:
            stream.write(out + "\n")
        return out


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a full trace of the host and, on a CUDA machine, the card
    (``torch.profiler.profile``); on exit a Chrome trace
    (``<worker>.<time>.pt.trace.json``, TensorBoard's layout) is written
    into ``logdir``, viewable in Perfetto or ``chrome://tracing``.  Spans
    opened under a :func:`record` scope appear in it by name."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, acc_events=True,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
