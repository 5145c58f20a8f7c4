"""ProfilerHook — ranges for external profilers + built-in summary
(``ginkgo_tpu/log/profiler_hook.py`` in torch).

Analog of ``include/ginkgo/core/log/profiler_hook.hpp:57`` (NVTX/ROCTX/TAU/
VTune range converters + ``create_summary:347``).  Ranges are
``torch.profiler.record_function`` spans, inside NVTX ranges on a CUDA
machine, and the built-in summary measures host wall time per named range
(synchronising the card is left to the caller).
"""

from __future__ import annotations

import contextlib
import time

import torch

from .logger import (LINOP_APPLY_COMPLETED, LINOP_APPLY_STARTED,
                     FACTORY_GENERATE_COMPLETED, FACTORY_GENERATE_STARTED,
                     SOLVE_COMPLETED, SOLVE_STARTED, Logger)


class ProfilerHook(Logger):
    """Collects begin/end event pairs into named ranges.

    ``create_summary()`` -> a dict of {name: (count, total_s)};
    ``write_summary()`` -> markdown table (profiler_hook_summary_writer
    analog).
    """

    _BEGIN_END = {
        LINOP_APPLY_STARTED: LINOP_APPLY_COMPLETED,
        FACTORY_GENERATE_STARTED: FACTORY_GENERATE_COMPLETED,
        SOLVE_STARTED: SOLVE_COMPLETED,
    }

    def __init__(self):
        super().__init__()
        self._open: dict[tuple, float] = {}
        self.ranges: dict[str, list[float]] = {}

    def on(self, event, **data):
        name = data.get("op_type") or data.get("solver") or event
        key = (event.rsplit("_", 1)[0], name, data.get("op_id"))
        if event.endswith("_started"):
            self._open[key] = time.perf_counter()
        elif event.endswith("_completed"):
            t0 = self._open.pop(key, None)
            if t0 is not None:
                self.ranges.setdefault(str(name), []).append(
                    time.perf_counter() - t0)

    def create_summary(self):
        return {name: (len(ts), sum(ts)) for name, ts in self.ranges.items()}

    def write_summary(self, stream=None) -> str:
        lines = ["| range | count | total [s] | avg [s] |",
                 "|---|---|---|---|"]
        for name, (cnt, tot) in sorted(self.create_summary().items(),
                                       key=lambda kv: -kv[1][1]):
            lines.append(f"| {name} | {cnt} | {tot:.6f} | {tot / cnt:.6f} |")
        out = "\n".join(lines)
        if stream is not None:
            stream.write(out + "\n")
        return out


@contextlib.contextmanager
def annotate(name: str):
    """One named profiler range: a ``record_function`` span (seen by
    ``torch.profiler``), inside an NVTX range on a CUDA machine."""
    nvtx = (torch.cuda.nvtx.range(name) if torch.cuda.is_available()
            else contextlib.nullcontext())
    with nvtx, torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a full trace of the host and, on a CUDA machine, the card
    (``torch.profiler.profile``); on exit a Chrome trace
    (``<worker>.<time>.pt.trace.json``, TensorBoard's layout) is written
    into ``logdir``, viewable in Perfetto or ``chrome://tracing``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, acc_events=True,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
