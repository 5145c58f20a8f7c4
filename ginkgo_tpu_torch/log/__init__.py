"""Observability (core/log analogs): event bus + sinks + the tracer's spans,
counters and profiler hook."""

from .logger import (Logger, Stream, Record, Convergence,  # noqa: F401
                     SolverProgress, PerformanceHint, add_logger,
                     remove_logger, capture, dispatch, has_loggers)
from .profiler_hook import (ProfilerHook, Span, count,  # noqa: F401
                            record, span, trace_to)
