"""Timers (``include/ginkgo/core/base/timer.hpp:80,146,166`` analogs;
``ginkgo_tpu/utils/timer.py`` in torch).

``CpuTimer`` measures host wall time; ``DeviceTimer`` brackets card work
with CUDA events (the reference's ``CudaTimer``), so the span it measures
is the card's, not the host's enqueueing.
"""

from __future__ import annotations

import platform
import time

import torch

from ..device import resolve_device


class CpuTimer:
    def __init__(self):
        self._t0 = None
        self.elapsed = 0.0

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        self.elapsed += time.perf_counter() - self._t0
        return self.elapsed


class DeviceTimer:
    """Times work on ``device`` (``None``: the CUDA device): on the card,
    ``tic`` synchronises (so the span starts from idle) and records a CUDA
    event; ``toc`` records another, waits for it and adds the events'
    elapsed time.  On the host, whose work is synchronous, it is the host
    clock.  ``elapsed`` is in seconds."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._start = None
        self.elapsed = 0.0

    def tic(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def toc(self, *results) -> float:
        """Adds the span since ``tic``; ``results`` (the work's outputs)
        are accepted for the reference's signature: the end event waits
        for all work queued before it."""
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            self.elapsed += self._start.elapsed_time(end) / 1e3
        else:
            self.elapsed += time.perf_counter() - self._start
        return self.elapsed


def topology():
    """machine_topology analog: the visible device inventory, the CUDA
    devices or, on a machine without one, the host."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        devices = [dict(id=i, kind=torch.cuda.get_device_name(i),
                        platform="gpu", process=0) for i in range(n)]
        backend = "cuda"
    else:
        devices = [dict(id=0, kind=platform.processor() or "cpu",
                        platform="cpu", process=0)]
        backend = "cpu"
    return {"backend": backend, "num_devices": len(devices),
            "local_devices": len(devices), "devices": devices}
