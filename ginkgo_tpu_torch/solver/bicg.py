"""BiCG, classic two-sided bi-conjugate gradients
(``ginkgo_tpu/solver/bicg.py`` in torch).

Analog of ``core/solver/bicg.cpp`` (``include/ginkgo/core/solver/bicg.hpp:53``).
Runs the dual recurrence with A^H and M^H; the conjugate transposes are built
once at solve setup, on the device of A (``Csr.conj_transpose``; a banded
matrix stays banded, so both products run on kernel A).
"""

from __future__ import annotations

import torch

from ..matrix.dense import compute_conj_dot, compute_norm2
from ..stop.criterion import CheckArgs, default_criterion
from .common import (SolverAPI, finish, prepare_rhs, resolve_precond,
                     run_iteration_loop, safe_div)


def _conj_transpose(op):
    if hasattr(op, "conj_transpose"):
        return op.conj_transpose()
    if hasattr(op, "transpose"):
        return op.transpose()
    # identity-like / symmetric default (Identity, Jacobi of a Hermitian A)
    return op


def solve(A, b, x0=None, *, criteria=None, preconditioner=None,
          trace: bool = False):
    """Solve A x = b with BiCG on the device of A and b."""
    b2, x, squeeze = prepare_rhs(A, b, x0)
    M = resolve_precond(preconditioner, A)
    if criteria is None:
        criteria = default_criterion(b2.dtype)
    At = _conj_transpose(A)
    Mt = _conj_transpose(M)

    def init_state(x):
        # also the audit restart: true r, fresh shadow/search vectors
        r = b2 - A._apply(x)
        ones = torch.ones((b2.shape[1],), dtype=r.dtype, device=r.device)
        return dict(x=x, r=r, r2=r, p=torch.zeros_like(r),
                    p2=torch.zeros_like(r), rho=ones)

    state = init_state(x)
    b_norm = compute_norm2(b2)
    r0_norm = compute_norm2(state["r"])

    def step(s, active):
        z = M._apply(s["r"])
        z2 = Mt._apply(s["r2"])
        rho = compute_conj_dot(s["r2"], z)
        beta = safe_div(rho, s["rho"])[None, :]
        p = z + beta * s["p"]
        p2 = z2 + beta * s["p2"]
        q = A._apply(p)
        q2 = At._apply(p2)
        alpha = safe_div(rho, compute_conj_dot(p2, q))[None, :]
        return dict(x=s["x"] + alpha * p, r=s["r"] - alpha * q,
                    r2=s["r2"] - torch.conj(alpha) * q2, p=p, p2=p2, rho=rho)

    def make_check_args(s, it):
        return CheckArgs(iteration=it, residual=s["r"])

    final, history = run_iteration_loop(
        step, make_check_args, state, criteria, b2, r0_norm, b_norm,
        trace=trace, restart_fn=lambda s: init_state(s["x"]))
    return finish(final, history, final["state"]["x"], final["state"]["r"],
                  squeeze)


Bicg = SolverAPI("Bicg", solve)
