"""Event-hook logger bus (the host-level subset of
``ginkgo_tpu/log/logger.py`` that the ported path fires).

Loggers subscribe globally (``add_logger``) or per ``with capture(logger):``
scope; events carry kwargs.
"""

from __future__ import annotations

import contextlib

LINOP_APPLY_STARTED = "linop_apply_started"
LINOP_APPLY_COMPLETED = "linop_apply_completed"
FACTORY_GENERATE_STARTED = "linop_factory_generate_started"
FACTORY_GENERATE_COMPLETED = "linop_factory_generate_completed"
SOLVE_COMPLETED = "solve_completed"
ITERATION_COMPLETE = "iteration_complete"   # host-side criteria loop
PERFORMANCE_FALLBACK = "performance_fallback"   # kernel left its fast tier
CRITERION_CHECK_COMPLETED = "criterion_check_completed"

ALL_EVENTS = frozenset({
    LINOP_APPLY_STARTED, LINOP_APPLY_COMPLETED, FACTORY_GENERATE_STARTED,
    FACTORY_GENERATE_COMPLETED, SOLVE_COMPLETED, ITERATION_COMPLETE,
    PERFORMANCE_FALLBACK, CRITERION_CHECK_COMPLETED,
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


def dispatch(event: str, **data):
    for lg in _global_loggers:
        if lg.wants(event):
            lg.on(event, **data)


def has_loggers() -> bool:
    return bool(_global_loggers)
