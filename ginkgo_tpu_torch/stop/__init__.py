"""Stopping criteria (core/stop analogs)."""

from .criterion import (CheckArgs, Combined, Criterion,  # noqa: F401
                        ImplicitResidualNorm, Iteration, ResidualNorm, Time,
                        default_criterion)
