"""Generate-path stage accounting: device compute vs host<->device
transfer vs host symbolics (``ginkgo_tpu/utils/stagetimer.py`` in torch).

The reference's benchmarks break solve phases into per-stage
``components`` objects (``benchmark/solver/solver_common.hpp:481-484``);
this is the analog for *generate* paths: a wall-clock ``generate`` number
mixes the device algorithm with host planning and host<->device copies.
Library code brackets its phases with :func:`stage`; when nothing is
collecting, the brackets are free (no sync points are added).

Usage (benchmark side)::

    with stagetimer.collect() as st:
        M = factory.generate(A)
    st.stages  # {'transfer': 0.4, 'device': 0.9}  (host = rest)

Library side::

    with stagetimer.stage('transfer'):
        AV = stagetimer.sync(torch.from_numpy(big_host_array).to(dev))
    with stagetimer.stage('device'):
        out = stagetimer.sync(device_loop(AV))
"""

from __future__ import annotations

import contextlib
import time

import torch

_active = None


class Collector:
    def __init__(self):
        self.stages: dict[str, float] = {}

    def add(self, name: str, seconds: float):
        self.stages[name] = self.stages.get(name, 0.0) + seconds


@contextlib.contextmanager
def collect():
    """Install a collector; yields it. Reentrant (inner collectors shadow
    outer ones for their extent)."""
    global _active
    prev, _active = _active, Collector()
    try:
        yield _active
    finally:
        _active = prev


def active() -> bool:
    return _active is not None


@contextlib.contextmanager
def stage(name: str):
    """Attribute the block's wall time to ``name`` when collecting; free
    otherwise.  The block should end with :func:`sync` on its device
    values, or the asynchronous launches leak into the next stage."""
    if _active is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _active.add(name, time.perf_counter() - t0)


def _cuda_devices(x, found):
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, found)
    return found


def sync(x):
    """``torch.cuda.synchronize()`` on every card that holds a tensor of
    ``x`` (a tensor or a dict/list/tuple of them) when collecting (the
    stage-boundary sync point); identity otherwise — production paths
    keep their launches asynchronous."""
    if _active is not None:
        for dev in _cuda_devices(x, set()):
            torch.cuda.synchronize(dev)
    return x
