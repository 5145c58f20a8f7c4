"""BiCGSTAB (``ginkgo_tpu/solver/bicgstab.py`` in torch).

Analog of ``core/solver/bicgstab.cpp`` (kernels initialize / step_1 / step_2 /
step_3 in ``core/solver/bicgstab_kernels.hpp``).  One loop iteration performs
the full stabilised bi-conjugate-gradient update in the JAX package's order;
the reference's mid-iteration ``s``-norm early exit is folded into the same
trip (columns whose ``s`` is already tiny take the finalising half-step
``x += alpha y`` with ``omega`` zeroed by :func:`safe_div`).  Two
preconditioner applies and two SpMVs per iteration.
"""

from __future__ import annotations

import torch

from ..matrix.dense import compute_conj_dot, compute_norm2
from ..stop.criterion import CheckArgs, default_criterion
from .common import (SolverAPI, finish, prepare_rhs, resolve_precond,
                     run_iteration_loop, safe_div)


def solve(A, b, x0=None, *, criteria=None, preconditioner=None,
          trace: bool = False):
    """Solve A x = b with preconditioned BiCGSTAB on the device of A and
    b."""
    b2, x, squeeze = prepare_rhs(A, b, x0)
    M = resolve_precond(preconditioner, A)
    if criteria is None:
        criteria = default_criterion(b2.dtype)

    def init_state(x):
        # also the audit restart: true r, fresh shadow/search vectors
        r = b2 - A._apply(x)
        ones = torch.ones((b2.shape[1],), dtype=r.dtype, device=r.device)
        return dict(x=x, r=r, rr=r, p=torch.zeros_like(r),
                    v=torch.zeros_like(r), rho=ones, alpha=ones,
                    omega=ones)

    state = init_state(x)
    b_norm = compute_norm2(b2)
    r0_norm = compute_norm2(state["r"])

    def step(s, active):
        rho = compute_conj_dot(s["rr"], s["r"])
        beta = safe_div(rho, s["rho"]) * safe_div(s["alpha"], s["omega"])
        p = s["r"] + beta[None, :] * (s["p"] - s["omega"][None, :] * s["v"])
        y = M._apply(p)
        v = A._apply(y)
        alpha = safe_div(rho, compute_conj_dot(s["rr"], v))
        sv = s["r"] - alpha[None, :] * v
        z = M._apply(sv)
        t = A._apply(z)
        omega = safe_div(compute_conj_dot(t, sv), compute_conj_dot(t, t))
        x = s["x"] + alpha[None, :] * y + omega[None, :] * z
        r = sv - omega[None, :] * t
        return dict(x=x, r=r, rr=s["rr"], p=p, v=v,
                    rho=rho, alpha=alpha, omega=omega)

    def make_check_args(s, it):
        return CheckArgs(iteration=it, residual=s["r"])

    final, history = run_iteration_loop(
        step, make_check_args, state, criteria, b2, r0_norm, b_norm,
        trace=trace, restart_fn=lambda s: init_state(s["x"]))
    return finish(final, history, final["state"]["x"], final["state"]["r"],
                  squeeze)


Bicgstab = SolverAPI("Bicgstab", solve)
