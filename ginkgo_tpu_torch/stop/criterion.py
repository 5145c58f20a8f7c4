"""Stopping criteria (``ginkgo_tpu/stop/criterion.py`` in torch).

Analog of Ginkgo's ``stop::Criterion`` event machinery
(``include/ginkgo/core/stop/criterion.hpp:36-105``): per-RHS-column status
lives in small bool tensors carried through the solver's host loop;
criteria are small config classes exposing

    init(b, r0_norm, b_norm) -> state   (captures baselines at solve start)
    check(state, args) -> (stop_mask (k,) bool, converged_mask, state)

where ``args`` is a :class:`CheckArgs` carrying whatever the solver has on
hand (iteration counter, recurrent residual / its norm, implicit squared
norm) — mirroring the updater fields of ``criterion.hpp:62-105``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..matrix.dense import compute_norm2

CONVERGED = 1
STOPPED = 2


@dataclasses.dataclass
class CheckArgs:
    """What the solver can offer the criteria this iteration."""

    iteration: int
    residual: Optional[torch.Tensor] = None            # (n, k)
    residual_norm: Optional[torch.Tensor] = None       # (k,)
    implicit_sq_residual_norm: Optional[torch.Tensor] = None  # (k,)
    solution: Optional[torch.Tensor] = None            # (n, k)

    def get_residual_norm(self):
        if self.residual_norm is not None:
            return self.residual_norm
        if self.residual is not None:
            return compute_norm2(self.residual)
        if self.implicit_sq_residual_norm is not None:
            return torch.sqrt(torch.abs(self.implicit_sq_residual_norm))
        raise ValueError("criterion needs a residual but solver gave none")


class Criterion:
    """Base: subclasses implement init/check."""

    def init(self, b, r0_norm, b_norm):
        return ()

    def check(self, state, args: CheckArgs):
        raise NotImplementedError

    # hard trip-count bound for the loop (None = unbounded)
    def max_trip_count(self):
        return None

    def __or__(self, other):
        mine = list(self.criteria) if isinstance(self, Combined) else [self]
        theirs = list(other.criteria) if isinstance(other, Combined) else [other]
        return Combined(criteria=tuple(mine + theirs))


@dataclasses.dataclass(frozen=True)
class Iteration(Criterion):
    """Stop (not converged) after ``max_iters`` iterations
    (``include/ginkgo/core/stop/iteration.hpp:25``)."""

    max_iters: int = 1000

    def check(self, state, args):
        k, device = _num_cols(args), _device_of(args)
        if isinstance(args.iteration, torch.Tensor):
            # per-column counts (the lanes of a batch solve, ``PerLane``)
            stop = args.iteration >= self.max_iters
        else:
            stop = torch.full((k,), bool(args.iteration >= self.max_iters),
                              device=device)
        return stop, torch.zeros((k,), dtype=torch.bool, device=device), state

    def max_trip_count(self):
        return self.max_iters


@dataclasses.dataclass(frozen=True)
class ResidualNorm(Criterion):
    """||r|| <= reduction_factor * baseline
    (``include/ginkgo/core/stop/residual_norm.hpp:37``); baseline is one of
    ``rhs_norm`` (default), ``initial_resnorm``, ``absolute``."""

    reduction_factor: float = 1e-8
    baseline: str = "rhs_norm"

    def init(self, b, r0_norm, b_norm):
        if self.baseline == "rhs_norm":
            return b_norm
        if self.baseline == "initial_resnorm":
            return r0_norm
        if self.baseline == "absolute":
            return torch.ones_like(b_norm)
        raise ValueError(f"unknown baseline {self.baseline!r}")

    def check(self, state, args):
        norm = args.get_residual_norm()
        conv = norm <= self.reduction_factor * state
        return conv, conv, state


@dataclasses.dataclass(frozen=True)
class ImplicitResidualNorm(Criterion):
    """Like ResidualNorm but on sqrt(|implicit rho|) — free in CG-type solvers
    (``residual_norm.hpp:113``)."""

    reduction_factor: float = 1e-8
    baseline: str = "rhs_norm"

    def init(self, b, r0_norm, b_norm):
        return ResidualNorm.init(self, b, r0_norm, b_norm)

    def check(self, state, args):
        if args.implicit_sq_residual_norm is not None:
            norm = torch.sqrt(torch.abs(args.implicit_sq_residual_norm))
        else:
            norm = args.get_residual_norm()
        conv = norm <= self.reduction_factor * state
        return conv, conv, state


@dataclasses.dataclass(frozen=True)
class Time(Criterion):
    """Wall-clock limit (``include/ginkgo/core/stop/time.hpp:24``).

    Host-side: reads the real clock, so a solve whose criteria include Time
    runs the plain host loop without the true-residual audit, as in the JAX
    package."""

    time_limit: float = 10.0   # seconds
    host_side = True

    def init(self, b, r0_norm, b_norm):
        return time.perf_counter()

    def check(self, state, args):
        k, device = _num_cols(args), _device_of(args)
        stop = time.perf_counter() - state > self.time_limit
        return (torch.full((k,), bool(stop), device=device),
                torch.zeros((k,), dtype=torch.bool, device=device), state)


def has_host_side(crit) -> bool:
    if getattr(crit, "host_side", False):
        return True
    if isinstance(crit, Combined):
        return any(has_host_side(c) for c in crit.criteria)
    if isinstance(crit, PerLane):
        return has_host_side(crit.criterion)
    return False


@dataclasses.dataclass(frozen=True)
class Combined(Criterion):
    """OR-composition (``include/ginkgo/core/stop/combined.hpp:26``)."""

    criteria: tuple = ()

    def init(self, b, r0_norm, b_norm):
        return tuple(c.init(b, r0_norm, b_norm) for c in self.criteria)

    def check(self, state, args):
        stops, convs, states = [], [], []
        for c, s in zip(self.criteria, state):
            st, cv, ns = c.check(s, args)
            stops.append(st)
            convs.append(cv)
            states.append(ns)
        stop = stops[0]
        conv = convs[0]
        for st, cv in zip(stops[1:], convs[1:]):
            stop = stop | st
            conv = conv | cv
        return stop, conv, tuple(states)

    def max_trip_count(self):
        counts = [c.max_trip_count() for c in self.criteria]
        counts = [c for c in counts if c is not None]
        return min(counts) if counts else None


@dataclasses.dataclass(frozen=True)
class PerLane(Criterion):
    """``criterion`` applied to independent lanes of ``width`` consecutive
    RHS columns each: the batch solvers' systems folded side by side into
    one solve.  The iteration loop then keeps its counters (iteration,
    trip cap, true-residual audit rounds) per lane, so each lane stops and
    is audited as if it were solved alone."""

    criterion: Criterion = None
    width: int = 1

    def init(self, b, r0_norm, b_norm):
        return self.criterion.init(b, r0_norm, b_norm)

    def check(self, state, args):
        return self.criterion.check(state, args)

    def max_trip_count(self):
        return self.criterion.max_trip_count()


def default_criterion(dtype, max_iters=1000, reduction_factor=None):
    """Iteration | ResidualNorm(rhs-relative) — the benchmark-suite default
    (``benchmark/solver/solver_common.hpp:120``)."""
    from ..base.dtypes import eps
    rf = reduction_factor if reduction_factor is not None else eps(dtype) * 1e3
    return Combined(criteria=(Iteration(max_iters=max_iters),
                              ResidualNorm(reduction_factor=rf)))


def as_criterion(obj) -> Criterion:
    if obj is None:
        raise ValueError("a stopping criterion is required")
    if isinstance(obj, Combined) and not obj.criteria:
        raise ValueError("Combined criterion needs at least one member")
    if isinstance(obj, Criterion):
        return obj
    if isinstance(obj, (list, tuple)):
        if not obj:
            raise ValueError("criteria list must not be empty")
        return Combined(criteria=tuple(obj))
    raise TypeError(f"not a criterion: {obj!r}")


def _num_cols(args: CheckArgs) -> int:
    for f in (args.residual_norm, args.implicit_sq_residual_norm):
        if f is not None:
            return f.shape[0]
    for f in (args.residual, args.solution):
        if f is not None:
            return f.shape[1]
    return 1


def _device_of(args: CheckArgs):
    for f in (args.residual_norm, args.implicit_sq_residual_norm,
              args.residual, args.solution):
        if f is not None:
            return f.device
    return None
