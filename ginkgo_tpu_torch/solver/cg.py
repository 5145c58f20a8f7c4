"""Conjugate gradient (``ginkgo_tpu/solver/cg.py`` in torch).

Analog of ``core/solver/cg.cpp`` (kernels ``core/solver/cg_kernels.hpp``:
initialize / step_1 / step_2).  One loop iteration performs Ginkgo's exact
update order (cg.cpp:142-176): z = M r; rho = <r, z>; p = z +
(rho/prev_rho) p; q = A p; beta = <p, q>; x += (rho/beta) p;
r -= (rho/beta) q.  The implicit squared residual norm rho feeds the
ImplicitResidualNorm criterion for free, as in the reference.
"""

from __future__ import annotations

import torch

from ..matrix.dense import compute_conj_dot, compute_norm2
from ..stop.criterion import CheckArgs, default_criterion
from .common import (SolverAPI, finish, prepare_rhs, resolve_precond,
                     run_iteration_loop, safe_div)


def solve(A, b, x0=None, *, criteria=None, preconditioner=None,
          trace: bool = False):
    """Solve A x = b with (preconditioned) CG on the device of A and b."""
    b2, x, squeeze = prepare_rhs(A, b, x0)
    M = resolve_precond(preconditioner, A)
    if criteria is None:
        criteria = default_criterion(b2.dtype)

    def init_state(x):
        # p starts at zero so the first step_1 yields p = z regardless
        # of the rho/prev_rho ratio (Ginkgo's initialize kernel
        # semantics); also the audit restart (true r, fresh direction).
        r = b2 - A._apply(x)
        return dict(x=x, r=r, p=torch.zeros_like(r),
                    rho=compute_conj_dot(r, M._apply(r)))

    state = init_state(x)
    b_norm = compute_norm2(b2)
    r0_norm = compute_norm2(state["r"])

    def step(s, active):
        z = M._apply(s["r"])
        rho = compute_conj_dot(s["r"], z)
        p = z + safe_div(rho, s["rho"])[None, :] * s["p"]
        q = A._apply(p)
        beta = compute_conj_dot(p, q)
        alpha = safe_div(rho, beta)[None, :]
        return dict(x=s["x"] + alpha * p, r=s["r"] - alpha * q, p=p, rho=rho)

    def make_check_args(s, it):
        return CheckArgs(iteration=it, residual=s["r"],
                         implicit_sq_residual_norm=s["rho"])

    final, history = run_iteration_loop(
        step, make_check_args, state, criteria, b2, r0_norm, b_norm,
        trace=trace, restart_fn=lambda s: init_state(s["x"]))
    return finish(final, history, final["state"]["x"], final["state"]["r"],
                  squeeze)


# Fluent factory surface: Cg.build(criteria=..., preconditioner=...)
# .generate(A) yields a solver LinOp (``cg.hpp:48`` analog).
Cg = SolverAPI("Cg", solve)
