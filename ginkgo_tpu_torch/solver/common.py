"""Shared iterative-solver driver (``ginkgo_tpu/solver/common.py`` in torch).

Ginkgo factors each solver into an ``apply_dense_impl`` host loop calling
fused per-iteration kernels (``core/solver/cg.cpp:92-180``) with
device-side per-column ``stopping_status``.  Here the loop is a Python loop
over tensors that syncs once per iteration (``any(active)``); the status
masks stay on the device, and converged columns are frozen by a masked
update (Ginkgo's per-column stopping semantics, multi-RHS included).

Solver-state convention: every tensor in the state dict has a trailing
RHS-column axis k — vectors are (n, k), iteration scalars are (k,) — so one
``where(active)`` broadcast freezes stopped columns across the whole state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..base.linop import LinOp, as_multivector
from ..matrix.dense import compute_norm2
from ..matrix.identity import Identity
from ..stop.criterion import Criterion, PerLane, as_criterion, has_host_side

DEFAULT_TRIP_CAP = 100_000


@dataclasses.dataclass
class SolveResult:
    """What Ginkgo's Convergence logger captures, as a return value."""

    x: torch.Tensor              # solution, caller's rank
    iterations: torch.Tensor     # (k,) int32 per-column iteration count
    resnorm: torch.Tensor        # (k,) final recurrent residual norm
    converged: torch.Tensor      # (k,) bool
    resnorm_history: Optional[torch.Tensor] = None
    # (k,) bool: the estimate-based criterion fired but the TRUE residual
    # missed the tolerance and retries ran out.
    stagnated: Optional[torch.Tensor] = None


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {key: _tree_map(fn, *(t[key] for t in trees)) for key in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *items) for items in zip(*trees))
    return fn(*trees)


def mask_cols(active, new, old):
    """Freeze stopped columns: per-tensor where() with trailing-k broadcast.

    Global scalars (0-d tensors, host ints) advance regardless; a tensor
    that is the same object in ``new`` and ``old`` was updated in place
    (the Krylov basis) and is kept as it is: its writer keeps stopped
    columns itself."""

    def sel(n, o):
        if not isinstance(n, torch.Tensor) or n.ndim == 0 or n is o:
            return n
        m = active.reshape((1,) * (n.ndim - 1) + (-1,))
        return torch.where(m, n, o)

    return _tree_map(sel, new, old)


def prepare_rhs(A, b, x0):
    """Canonicalise b/x0 to (n, k); returns (b2, x2, squeeze).

    ``x0`` may be a tensor (provided guess), None (zero guess), or one of
    the ``initial_guess_mode`` names 'zero'/'rhs' from Ginkgo's
    ApplyWithInitialGuess (``solver_base.hpp:33``)."""
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"iterative solvers need a square operator, "
                         f"got {A.shape}")
    b2, squeeze = as_multivector(b)
    if b2.shape[0] != A.shape[0]:
        raise ValueError(f"rhs rows {b2.shape[0]} != op rows {A.shape[0]}")
    if x0 is None or (isinstance(x0, str) and x0 == "zero"):
        x2 = torch.zeros_like(b2)
    elif isinstance(x0, str) and x0 == "rhs":
        x2 = b2
    elif isinstance(x0, str):
        raise ValueError(f"unknown initial_guess_mode {x0!r}")
    else:
        x2, _ = as_multivector(x0)
    return b2, x2, squeeze


def resolve_precond(preconditioner, A):
    """None -> Identity; factory-like (has .generate) -> generate(A)."""
    if preconditioner is None:
        return Identity(size=A.shape[0])
    if hasattr(preconditioner, "generate") and not isinstance(
            preconditioner, LinOp):
        return preconditioner.generate(A)
    return preconditioner


def run_iteration_loop(step_fn, make_check_args, state0, criterion: Criterion,
                       b, r0_norm, b_norm, *, trace: bool = False,
                       trip_cap: int | None = None, restart_fn=None,
                       verify_retries: int = 2):
    """The host loop shared by the Krylov solvers.

    step_fn(state, active) -> state'  one iteration (unmasked); ``active``
                                      is the (k,) mask of running columns
    make_check_args(state, it) -> CheckArgs

    ``restart_fn(state) -> state`` (optional) re-initializes the solver
    from its current iterate with a TRUE residual r = b - A x.  When
    given, estimate-based convergence is AUDITED: once the loop stops,
    the criterion is re-checked against the recomputed residual; a
    column whose recurrent estimate fired but whose true residual
    misses is restarted and continues (up to ``verify_retries`` times),
    after which it reports ``stagnated`` instead of claiming a
    convergence the true residual contradicts.  A criterion that reads
    the host clock (``Time``) runs the plain loop without the audit and
    fires the per-iteration logger events, as in the JAX package.

    ``trace=True`` (without a host-side criterion, which ignores it, as the
    JAX package does) runs without the audit and returns the residual norm
    of every trip: the JAX package's ``lax.scan`` always runs ``cap`` trips
    and repeats the last norm once every column has stopped; this loop
    stops there and pads the (cap + 1, k) history with its last row.

    A ``PerLane`` criterion splits the columns into lanes of its ``width``
    (a batch of systems folded side by side): see :func:`_run_lanes`.
    """
    criterion = as_criterion(criterion)
    if isinstance(criterion, PerLane):
        if trace or has_host_side(criterion):
            raise ValueError("per-lane solves take neither trace=True nor "
                             "a host-side criterion")
        return _run_lanes(step_fn, make_check_args, state0, criterion, b,
                          r0_norm, b_norm, trip_cap, restart_fn,
                          verify_retries), None
    crit_state = criterion.init(b, r0_norm, b_norm)
    cap = trip_cap if trip_cap is not None else (
        criterion.max_trip_count() or DEFAULT_TRIP_CAP)
    k = b.shape[1]

    args0 = make_check_args(state0, 0)
    stop0, conv0, crit_state = criterion.check(crit_state, args0)
    carry0 = dict(state=state0, crit=crit_state, it=0, active=~stop0,
                  converged=conv0,
                  iters=torch.zeros((k,), dtype=torch.int32,
                                    device=b.device))

    # With a single RHS column there is nothing to freeze: the loop exits
    # as soon as the one column stops, so the per-column select is waste.
    single_col = k == 1
    host_side = has_host_side(criterion)

    def body(carry):
        new_state = step_fn(carry["state"], carry["active"])
        state = (new_state if single_col else
                 mask_cols(carry["active"], new_state, carry["state"]))
        it = carry["it"] + 1
        args = make_check_args(state, it)
        stop, conv, crit = criterion.check(carry["crit"], args)
        newly = carry["active"] & stop
        if host_side:
            _log_iteration(it, stop, conv)
        return dict(
            state=state, crit=crit, it=it,
            active=carry["active"] & ~stop,
            converged=carry["converged"] | (newly & conv),
            iters=carry["iters"] + carry["active"].to(torch.int32))

    def run(carry):
        while carry["it"] < cap and bool(carry["active"].any()):
            carry = body(carry)
        return carry

    if host_side or (restart_fn is None and not trace):
        return run(carry0), None
    if trace:
        history = [args0.get_residual_norm()]
        carry = carry0
        while carry["it"] < cap and bool(carry["active"].any()):
            carry = body(carry)
            history.append(make_check_args(carry["state"], carry["it"])
                           .get_residual_norm())
        history = torch.stack(history)
        pad = history[-1:].expand(cap + 1 - history.shape[0], k)
        return carry, torch.cat([history, pad])

    def audit(oc):
        c = run(oc["carry"])
        s2 = restart_fn(c["state"])
        args = make_check_args(s2, c["it"])
        _, conv_t, crit_t = criterion.check(c["crit"], args)
        # estimate-claimed convergence the true residual contradicts
        bogus = c["converged"] & ~conv_t
        out_of = oc["audits"] >= verify_retries     # a Python bool
        redo = bogus & (not out_of)
        state = s2 if single_col else mask_cols(redo, s2, c["state"])
        c2 = dict(c, state=state, crit=crit_t, active=redo,
                  converged=c["converged"] & ~bogus)
        return dict(carry=c2,
                    stagnated=oc["stagnated"] | (bogus & out_of),
                    audits=oc["audits"] + 1)

    oc = audit(dict(carry=carry0,
                    stagnated=torch.zeros((k,), dtype=torch.bool,
                                          device=b.device),
                    audits=0))
    while oc["carry"]["it"] < cap and bool(oc["carry"]["active"].any()):
        oc = audit(oc)
    return dict(oc["carry"], stagnated=oc["stagnated"]), None


def _run_lanes(step_fn, make_check_args, state0, criterion, b, r0_norm,
               b_norm, trip_cap, restart_fn, verify_retries):
    """``run_iteration_loop`` over lanes of ``criterion.width`` columns,
    each lane as if it were solved alone (the JAX package's ``vmap`` of a
    whole solve): the iteration count, the trip cap and the audit rounds
    are per lane (one host read of the lanes still running a trip).  A
    lane of one column takes its restarted state at every audit it joins,
    as a one-column solve does (``single_col``); wider lanes take it for
    their redone columns only."""
    crit_state = criterion.init(b, r0_norm, b_norm)
    cap = trip_cap if trip_cap is not None else (
        criterion.max_trip_count() or DEFAULT_TRIP_CAP)
    k, w = b.shape[1], criterion.width
    lanes = k // w
    dev = b.device

    def cols(lane_values):
        return lane_values.repeat_interleave(w)

    def running(carry):
        """(lanes,) lanes with an active column and trips left."""
        return carry["active"].view(lanes, w).any(dim=1) & (carry["it"] < cap)

    it0 = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    stop0, conv0, crit_state = criterion.check(
        crit_state, make_check_args(state0, cols(it0)))
    carry0 = dict(state=state0, crit=crit_state, it=it0, active=~stop0,
                  converged=conv0,
                  iters=torch.zeros((k,), dtype=torch.int32, device=dev))

    def body(carry, run):
        run_cols = cols(run)
        moving = carry["active"] & run_cols
        state = mask_cols(moving, step_fn(carry["state"], moving),
                          carry["state"])
        it = carry["it"] + run.to(torch.int32)
        stop, conv, crit = criterion.check(
            carry["crit"], make_check_args(state, cols(it)))
        stop = stop & run_cols
        return dict(state=state, crit=crit, it=it,
                    active=carry["active"] & ~stop,
                    converged=carry["converged"] | (moving & stop & conv),
                    iters=carry["iters"] + moving.to(torch.int32))

    def run_all(carry):
        run = running(carry)
        while bool(run.any()):
            carry = body(carry, run)
            run = running(carry)
        return carry

    if restart_fn is None:
        return run_all(carry0)

    def audit(oc, part):
        """One audit round for the lanes of ``part``."""
        c = run_all(oc["carry"])
        part_cols = cols(part)
        s2 = restart_fn(c["state"])
        _, conv_t, crit_t = criterion.check(
            c["crit"], make_check_args(s2, cols(c["it"])))
        bogus = c["converged"] & ~conv_t & part_cols
        out_of = cols(oc["audits"] >= verify_retries)
        redo = bogus & ~out_of
        take = part_cols if w == 1 else redo
        c2 = dict(c, state=mask_cols(take, s2, c["state"]), crit=crit_t,
                  active=torch.where(part_cols, redo, c["active"]),
                  converged=c["converged"] & ~bogus)
        return dict(carry=c2, stagnated=oc["stagnated"] | (bogus & out_of),
                    audits=oc["audits"] + part.to(torch.int32))

    oc = audit(dict(carry=carry0,
                    stagnated=torch.zeros((k,), dtype=torch.bool,
                                          device=dev),
                    audits=torch.zeros((lanes,), dtype=torch.int32,
                                       device=dev)),
               torch.ones((lanes,), dtype=torch.bool, device=dev))
    part = running(oc["carry"])
    while bool(part.any()):
        oc = audit(oc, part)
        part = running(oc["carry"])
    return dict(oc["carry"], stagnated=oc["stagnated"])


def run_restarted_loop(inner_step, cycle_done, restart_fn, make_check_args,
                       state0, criterion: Criterion, b, r0_norm, b_norm,
                       trip_cap: int | None = None, verify_retries: int = 2):
    """Two-level host loop for restarted solvers (GMRES-style).

    inner_step(state, active) -> state'   one inner step (unmasked)
    cycle_done(state) -> bool             the cycle is full (a host value)
    restart_fn(state, sel) -> state'      restart from the TRUE residual
                                          r = b - A x for the columns of sel

    The inner loop runs only ``inner_step`` and the criterion check, one
    host read of the active mask a step; ``restart_fn`` runs in the outer
    loop, once per cycle.  The masks hand the solver the columns it works
    on, so a buffer it updates in place (the Krylov basis) can keep the
    stopped columns itself.

    CONVERGENCE IS VERIFIED ON THE TRUE RESIDUAL.  Inner steps stop columns
    on the solver's recurrent estimate (GMRES' ``|g[j+1]|``); the restart
    recomputes the residual, and a column whose estimate fired is
    re-checked against it before ``converged`` becomes final.  On a miss
    the column is reactivated for another cycle (up to ``verify_retries``
    times); when the retries run out it is reported ``stagnated``.

    Iteration counts tick per inner step only (restarts are free), which
    matches the reference's counting.
    """
    criterion = as_criterion(criterion)
    crit_state = criterion.init(b, r0_norm, b_norm)
    cap = trip_cap if trip_cap is not None else (
        criterion.max_trip_count() or DEFAULT_TRIP_CAP)
    k = b.shape[1]
    single_col = k == 1
    zeros = torch.zeros((k,), dtype=torch.int32, device=b.device)

    # state0 comes fresh from the solver's restart, so the initial check
    # runs on the TRUE residual: columns converging here are verified.
    args0 = make_check_args(state0, 0)
    stop0, conv0, crit_state = criterion.check(crit_state, args0)
    carry = dict(state=state0, crit=crit_state, it=0, active=~stop0,
                 converged=conv0, verified=conv0, retries=zeros,
                 stagnated=torch.zeros((k,), dtype=torch.bool,
                                       device=b.device),
                 iters=zeros)

    def inner_body(carry):
        new_state = inner_step(carry["state"], carry["active"])
        state = (new_state if single_col else
                 mask_cols(carry["active"], new_state, carry["state"]))
        it = carry["it"] + 1
        args = make_check_args(state, it)
        stop, conv, crit = criterion.check(carry["crit"], args)
        newly = carry["active"] & stop
        return dict(
            carry, state=state, crit=crit, it=it,
            active=carry["active"] & ~stop,
            # provisional: estimate-based, audited at the next restart
            converged=carry["converged"] | (newly & conv),
            iters=carry["iters"] + carry["active"].to(torch.int32))

    def outer_body(carry):
        while (carry["it"] < cap and not cycle_done(carry["state"])
               and bool(carry["active"].any())):
            carry = inner_body(carry)
        # columns whose estimate-based stop awaits a true-residual audit
        pending = carry["converged"] & ~carry["verified"]
        sel = carry["active"] | pending
        state = restart_fn(carry["state"], sel)
        if not single_col:
            state = mask_cols(sel, state, carry["state"])
        # the restart recomputes r = b - A x, so this check is on the TRUE
        # residual; it does not tick `it` (restarts are free)
        args = make_check_args(state, carry["it"])
        stop, conv, crit = criterion.check(carry["crit"], args)
        hit = stop & conv
        # active columns stopping at the boundary are verified by
        # construction (their stop IS the true-residual check)
        newly = carry["active"] & stop
        converged = carry["converged"] | (newly & conv)
        verified = carry["verified"] | (newly & conv)
        active = carry["active"] & ~stop
        # pending columns: confirm, retry another cycle, or give up
        ok = pending & hit
        miss = pending & ~hit
        give_up = miss & (carry["retries"] >= verify_retries)
        redo = miss & ~give_up
        return dict(
            state=state, crit=crit, it=carry["it"],
            active=active | redo,
            converged=converged & ~miss,
            verified=verified | ok,
            retries=carry["retries"] + redo.to(torch.int32),
            stagnated=carry["stagnated"] | give_up,
            iters=carry["iters"])

    def outer_cond(carry):
        pending = carry["converged"] & ~carry["verified"]
        work = carry["active"].any() if carry["it"] < cap else False
        return bool(work | pending.any())     # one host read

    while outer_cond(carry):
        carry = outer_body(carry)
    return carry, None


def _log_iteration(it, stop, conv):
    from ..log import logger as _log
    if _log.has_loggers():
        _log.dispatch(_log.ITERATION_COMPLETE, iteration=int(it))
        _log.dispatch(_log.CRITERION_CHECK_COMPLETED, iteration=int(it),
                      num_stopped=int(stop.sum()),
                      num_converged=int((conv & stop).sum()))


def finish(final, history, x, r, squeeze):
    """Assemble a SolveResult from the loop carry + extracted x, r."""
    resnorm = compute_norm2(r)
    result = SolveResult(
        x=x[:, 0] if squeeze else x,
        iterations=final["iters"],
        resnorm=resnorm,
        converged=final["converged"],
        resnorm_history=history,
        stagnated=final.get("stagnated"))
    from ..log import logger as _log
    if _log.has_loggers():
        _log.dispatch(_log.SOLVE_COMPLETED, result=result)
    return result


def safe_div(num, den):
    """num/den with 0/0 -> 0 (stopped columns carry zeroed updates)."""
    safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.zeros_like(num), num / safe)


# ---------------------------------------------------------------------------
# Solver-as-LinOp + fluent factory machinery: ``Cg.build(criteria=...,
# preconditioner=...).generate(A)`` yields a LinOp whose apply solves.
# ---------------------------------------------------------------------------


class SolverOp(LinOp):
    """A generated solver: LinOp whose apply runs ``solve_fn``."""

    def __init__(self, system_matrix, preconditioner=None, criteria=None,
                 solve_fn=None, name="solver", params=()):
        self.system_matrix = system_matrix
        self.preconditioner = preconditioner
        self.criteria = criteria
        self.solve_fn = solve_fn
        self.name = name
        self.params = tuple(params)

    @property
    def shape(self):
        return self.system_matrix.shape

    def _apply(self, b):
        return self.solve(b).x

    def solve(self, b, x0=None, **kw):
        kwargs = dict(self.params)
        if self.preconditioner is not None:
            kwargs["preconditioner"] = self.preconditioner
        kwargs.update(kw)
        return self.solve_fn(self.system_matrix, b, x0,
                             criteria=self.criteria, **kwargs)


class SolverFactory:
    """The ``build()`` product: holds params, generates SolverOps."""

    def __init__(self, solve_fn, name, params):
        self.solve_fn = solve_fn
        self.name = name
        self.params = dict(params)

    def generate(self, A) -> SolverOp:
        from ..log import logger as _log
        _log.dispatch(_log.FACTORY_GENERATE_STARTED, op_type=self.name,
                      op_id=id(self))
        params = dict(self.params)
        criteria = params.pop("criteria", None)
        M = params.pop("preconditioner", None)
        if M is not None:
            M = resolve_precond(M, A)
        op = SolverOp(system_matrix=A, preconditioner=M, criteria=criteria,
                      solve_fn=self.solve_fn, name=self.name,
                      params=sorted(params.items()))
        _log.dispatch(_log.FACTORY_GENERATE_COMPLETED, op_type=self.name,
                      op_id=id(self))
        return op


class SolverAPI:
    """Class-like facade: ``Cg.build(...)`` / ``Cg.solve(A, b, ...)``."""

    def __init__(self, name, solve_fn):
        self.__name__ = self.name = name
        self.solve = solve_fn

    def build(self, **params) -> SolverFactory:
        return SolverFactory(self.solve, self.name, params)

    def __call__(self, **params) -> SolverFactory:
        return self.build(**params)

    def __repr__(self):
        return f"<solver {self.name}>"
