"""Flexible CG (``ginkgo_tpu/solver/fcg.py`` in torch).

Analog of ``core/solver/fcg.cpp`` (``include/ginkgo/core/solver/fcg.hpp:52``):
CG with the Polak-Ribiere style beta ``rho_t / prev_rho`` where
``rho_t = <r_new - r_old, z>``, making the method robust to non-constant
(flexible) preconditioners.  Since ``r_new - r_old = -alpha q``, Ginkgo's
``t`` vector is ``-alpha q`` here.
"""

from __future__ import annotations

import torch

from ..matrix.dense import compute_conj_dot, compute_norm2
from ..stop.criterion import CheckArgs, default_criterion
from .common import (SolverAPI, finish, prepare_rhs, resolve_precond,
                     run_iteration_loop, safe_div)


def solve(A, b, x0=None, *, criteria=None, preconditioner=None,
          trace: bool = False):
    """Solve A x = b with flexible CG on the device of A and b."""
    b2, x, squeeze = prepare_rhs(A, b, x0)
    M = resolve_precond(preconditioner, A)
    if criteria is None:
        criteria = default_criterion(b2.dtype)

    def init_state(x):
        # t starts equal to r so the first beta reduces to plain CG's
        # rho/1 with p = 0 (Ginkgo's initialize kernel semantics); also
        # the audit restart (true r, fresh direction).
        r = b2 - A._apply(x)
        ones = torch.ones((b2.shape[1],), dtype=r.dtype, device=r.device)
        return dict(x=x, r=r, t=r, p=torch.zeros_like(r), prev_rho=ones,
                    rho=compute_conj_dot(r, M._apply(r)))

    state = init_state(x)
    b_norm = compute_norm2(b2)
    r0_norm = compute_norm2(state["r"])

    def step(s, active):
        z = M._apply(s["r"])
        rho = compute_conj_dot(s["r"], z)
        rho_t = compute_conj_dot(s["t"], z)
        p = z + safe_div(rho_t, s["prev_rho"])[None, :] * s["p"]
        q = A._apply(p)
        beta = compute_conj_dot(p, q)
        alpha = safe_div(rho, beta)[None, :]
        return dict(x=s["x"] + alpha * p, r=s["r"] - alpha * q,
                    t=-alpha * q, p=p, prev_rho=rho, rho=rho)

    def make_check_args(s, it):
        return CheckArgs(iteration=it, residual=s["r"],
                         implicit_sq_residual_norm=s["rho"])

    final, history = run_iteration_loop(
        step, make_check_args, state, criteria, b2, r0_norm, b_norm,
        trace=trace, restart_fn=lambda s: init_state(s["x"]))
    return finish(final, history, final["state"]["x"], final["state"]["r"],
                  squeeze)


Fcg = SolverAPI("Fcg", solve)
