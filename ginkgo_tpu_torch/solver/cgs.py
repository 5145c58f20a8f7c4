"""Conjugate gradient squared (``ginkgo_tpu/solver/cgs.py`` in torch).

Analog of ``core/solver/cgs.cpp`` (``include/ginkgo/core/solver/cgs.hpp:44``).
Transpose-free two-term recurrence squaring the BiCG polynomial; two SpMVs
and two preconditioner applies per iteration.
"""

from __future__ import annotations

import torch

from ..matrix.dense import compute_conj_dot, compute_norm2
from ..stop.criterion import CheckArgs, default_criterion
from .common import (SolverAPI, finish, prepare_rhs, resolve_precond,
                     run_iteration_loop, safe_div)


def solve(A, b, x0=None, *, criteria=None, preconditioner=None,
          trace: bool = False):
    """Solve A x = b with CGS on the device of A and b."""
    b2, x, squeeze = prepare_rhs(A, b, x0)
    M = resolve_precond(preconditioner, A)
    if criteria is None:
        criteria = default_criterion(b2.dtype)

    def init_state(x):
        # also the audit restart: true r, fresh shadow/search vectors
        r = b2 - A._apply(x)
        ones = torch.ones((b2.shape[1],), dtype=r.dtype, device=r.device)
        return dict(x=x, r=r, rr=r, p=torch.zeros_like(r),
                    q=torch.zeros_like(r), rho=ones)

    state = init_state(x)
    b_norm = compute_norm2(b2)
    r0_norm = compute_norm2(state["r"])

    def step(s, active):
        rho = compute_conj_dot(s["rr"], s["r"])
        beta = safe_div(rho, s["rho"])[None, :]
        u = s["r"] + beta * s["q"]
        p = u + beta * (s["q"] + beta * s["p"])
        p_hat = M._apply(p)
        v = A._apply(p_hat)
        gamma = compute_conj_dot(s["rr"], v)
        alpha = safe_div(rho, gamma)[None, :]
        q = u - alpha * v
        t_hat = M._apply(u + q)
        x = s["x"] + alpha * t_hat
        r = s["r"] - alpha * A._apply(t_hat)
        return dict(x=x, r=r, rr=s["rr"], p=p, q=q, rho=rho)

    def make_check_args(s, it):
        return CheckArgs(iteration=it, residual=s["r"])

    final, history = run_iteration_loop(
        step, make_check_args, state, criteria, b2, r0_norm, b_norm,
        trace=trace, restart_fn=lambda s: init_state(s["x"]))
    return finish(final, history, final["state"]["x"], final["state"]["r"],
                  squeeze)


Cgs = SolverAPI("Cgs", solve)
