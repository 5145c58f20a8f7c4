"""Event-hook logger bus (``ginkgo_tpu/log/logger.py`` in torch).

Analog of ``include/ginkgo/core/log/logger.hpp:110-547``: the bus carries
host-level events — operation/apply begin-end, factory generate, solve
completion (with the result as payload), the host loop's per-iteration
events, batch solves — and the per-iteration residual channel is the
``trace=True`` history (SolverProgress).  Payload tensors may live on
the card; the sinks read them with ``.cpu()``.

Loggers subscribe globally (``add_logger``) or per ``with capture(logger):``
scope; events carry kwargs.  Masks mirror Ginkgo's event grouping.
"""

from __future__ import annotations

import contextlib
import sys

# event names (logger.hpp event slots, host-level subset)
LINOP_APPLY_STARTED = "linop_apply_started"
LINOP_APPLY_COMPLETED = "linop_apply_completed"
FACTORY_GENERATE_STARTED = "linop_factory_generate_started"
FACTORY_GENERATE_COMPLETED = "linop_factory_generate_completed"
SOLVE_STARTED = "solve_started"
SOLVE_COMPLETED = "solve_completed"
ITERATION_COMPLETE = "iteration_complete"   # host-side criteria loop
IO_READ = "io_read"
IO_WRITE = "io_write"
PERFORMANCE_FALLBACK = "performance_fallback"   # kernel left its fast tier
# criterion_check_completed analog (host-side criteria loop; per check)
CRITERION_CHECK_COMPLETED = "criterion_check_completed"
# batch::log::BatchConvergence analog: fires once per batch solve with
# the per-system iterations/residuals in the result
BATCH_SOLVE_COMPLETED = "batch_solve_completed"

ALL_EVENTS = frozenset({
    LINOP_APPLY_STARTED, LINOP_APPLY_COMPLETED, FACTORY_GENERATE_STARTED,
    FACTORY_GENERATE_COMPLETED, SOLVE_STARTED, SOLVE_COMPLETED,
    ITERATION_COMPLETE, IO_READ, IO_WRITE, PERFORMANCE_FALLBACK,
    CRITERION_CHECK_COMPLETED, BATCH_SOLVE_COMPLETED,
})


class Logger:
    """Base logger; subclasses implement ``on(event, **data)``.
    ``events_mask`` restricts delivery (Ginkgo's mask_type)."""

    def __init__(self, events_mask=None):
        self.events_mask = (frozenset(events_mask) if events_mask is not None
                            else ALL_EVENTS)

    def on(self, event: str, **data):
        raise NotImplementedError

    def wants(self, event: str) -> bool:
        return event in self.events_mask


_global_loggers: list[Logger] = []


def add_logger(logger: Logger):
    _global_loggers.append(logger)
    return logger


def remove_logger(logger: Logger):
    _global_loggers.remove(logger)


@contextlib.contextmanager
def capture(*loggers: Logger):
    """Scope-local logger registration."""
    for lg in loggers:
        add_logger(lg)
    try:
        yield loggers[0] if len(loggers) == 1 else loggers
    finally:
        for lg in loggers:
            remove_logger(lg)


@contextlib.contextmanager
def silenced():
    """No event reaches a logger inside the scope: for a solve whose
    events belong to an outer one (the folded lanes of a batch solve,
    which report as one ``BATCH_SOLVE_COMPLETED``)."""
    saved = _global_loggers[:]
    _global_loggers.clear()
    try:
        yield
    finally:
        _global_loggers[:] = saved


def dispatch(event: str, **data):
    for lg in _global_loggers:
        if lg.wants(event):
            lg.on(event, **data)


def has_loggers() -> bool:
    return bool(_global_loggers)


# ---------------------------------------------------------------------------
# Sinks (core/log/* analogs)
# ---------------------------------------------------------------------------

class Stream(Logger):
    """Text-trace sink (``log/stream.hpp:30``)."""

    def __init__(self, stream=None, events_mask=None):
        super().__init__(events_mask)
        self.stream = stream if stream is not None else sys.stderr

    def on(self, event, **data):
        parts = ", ".join(f"{k}={_short(v)}" for k, v in data.items())
        self.stream.write(f"[ginkgo_tpu_torch] {event}: {parts}\n")


class Record(Logger):
    """In-memory event ring (``log/record.hpp:215``)."""

    def __init__(self, max_storage: int = 0, events_mask=None):
        super().__init__(events_mask)
        self.max_storage = max_storage
        self.data: list[tuple[str, dict]] = []

    def on(self, event, **data):
        self.data.append((event, data))
        if self.max_storage and len(self.data) > self.max_storage:
            self.data.pop(0)


class Convergence(Logger):
    """Captures the last solve's iteration count / residual norm
    (``log/convergence.hpp:37``)."""

    def __init__(self):
        super().__init__({SOLVE_COMPLETED})
        self.result = None

    def on(self, event, **data):
        self.result = data.get("result")

    @property
    def num_iterations(self):
        return (None if self.result is None
                else int(self.result.iterations.max().cpu()))

    @property
    def residual_norm(self):
        return (None if self.result is None
                else self.result.resnorm.cpu().numpy())

    def has_converged(self):
        return (self.result is not None
                and bool(self.result.converged.all().cpu()))


class SolverProgress(Logger):
    """Per-iteration residual table (``log/solver_progress.hpp:24``) — fed
    by solves run with ``trace=True`` (the resnorm_history channel)."""

    def __init__(self, stream=None):
        super().__init__({SOLVE_COMPLETED})
        self.stream = stream
        self.history = None

    def on(self, event, **data):
        res = data.get("result")
        if res is None or res.resnorm_history is None:
            return
        self.history = res.resnorm_history.cpu().numpy()
        if self.stream is not None:
            for it, row in enumerate(self.history):
                self.stream.write(f"{it}\t" + "\t".join(
                    f"{v:.6e}" for v in row.reshape(-1)) + "\n")


class PerformanceHint(Logger):
    """Detects wasteful usage patterns (``log/performance_hint.hpp:29``):
    an operator applied one right-hand side at a time over and over, and
    kernels that left their fast tier."""

    def __init__(self, stream=None, threshold: int = 10):
        super().__init__({LINOP_APPLY_COMPLETED, PERFORMANCE_FALLBACK})
        self.stream = stream if stream is not None else sys.stderr
        self.threshold = threshold
        self._counts: dict[int, int] = {}
        self._warned: set = set()

    def on(self, event, **data):
        if event == PERFORMANCE_FALLBACK:
            key = ("fallback", data.get("kernel"), data.get("reason"))
            if key not in self._warned:
                self._warned.add(key)
                self.stream.write(
                    f"[ginkgo_tpu_torch hint] {data.get('kernel')} fell back "
                    f"to the slow reference tier: {data.get('reason')}\n")
            return
        key = data.get("op_id")
        if key is None:
            return
        self._counts[key] = self._counts.get(key, 0) + 1
        if (self._counts[key] == self.threshold
                and key not in self._warned):
            self._warned.add(key)
            self.stream.write(
                f"[ginkgo_tpu_torch hint] operator {data.get('op_type')} "
                f"applied {self.threshold}x one call at a time — stack the "
                "right-hand sides into one (n, k) apply to pay the per-call "
                "launch overhead once\n")


def _short(v):
    s = repr(v)
    return s if len(s) <= 60 else s[:57] + "..."
