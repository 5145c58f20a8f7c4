"""Observability (core/log analogs): event bus + sinks + profiler hook."""

from .logger import (Logger, Stream, Record, Convergence,  # noqa: F401
                     SolverProgress, PerformanceHint, add_logger,
                     remove_logger, capture, dispatch, has_loggers)
from .profiler_hook import ProfilerHook, annotate, trace_to  # noqa: F401
