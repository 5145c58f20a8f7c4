"""Pipelined CG, one fused reduction round per iteration
(``ginkgo_tpu/solver/pipe_cg.py`` in torch).

Analog of ``core/solver/pipe_cg.cpp``
(``include/ginkgo/core/solver/pipe_cg.hpp:61``): the Ghysels-Vanroose
recurrence computes both inner products (gamma = <r,u>, delta = <w,u>) from
the *same* vectors, so a distributed run needs one reduction round per
iteration.  The trip counter ``it`` is a host int, as GMRES's Arnoldi index.
"""

from __future__ import annotations

import torch

from ..matrix.dense import compute_conj_dot, compute_norm2
from ..stop.criterion import CheckArgs, default_criterion
from .common import (SolverAPI, finish, prepare_rhs, resolve_precond,
                     run_iteration_loop, safe_div)


def solve(A, b, x0=None, *, criteria=None, preconditioner=None,
          trace: bool = False):
    """Solve A x = b with pipelined CG on the device of A and b."""
    b2, x, squeeze = prepare_rhs(A, b, x0)
    M = resolve_precond(preconditioner, A)
    if criteria is None:
        criteria = default_criterion(b2.dtype)

    r = b2 - A._apply(x)
    u = M._apply(r)
    w = A._apply(u)
    ones = torch.ones((b2.shape[1],), dtype=b2.dtype, device=b2.device)
    z0 = torch.zeros_like(r)
    state = dict(x=x, r=r, u=u, w=w, z=z0, q=z0, s=z0, p=z0,
                 gamma_old=ones, alpha_old=ones, it=0)
    b_norm = compute_norm2(b2)
    r0_norm = compute_norm2(r)

    def step(st, active):
        gamma = compute_conj_dot(st["r"], st["u"])
        delta = compute_conj_dot(st["w"], st["u"])
        m = M._apply(st["w"])
        n = A._apply(m)
        if st["it"] == 0:
            beta = torch.zeros_like(gamma)
            alpha = safe_div(gamma, delta)
        else:
            beta = safe_div(gamma, st["gamma_old"])
            denom = delta - beta * safe_div(gamma, st["alpha_old"])
            alpha = safe_div(gamma, denom)
        z = n + beta[None, :] * st["z"]
        q = m + beta[None, :] * st["q"]
        s = st["w"] + beta[None, :] * st["s"]
        p = st["u"] + beta[None, :] * st["p"]
        a = alpha[None, :]
        return dict(x=st["x"] + a * p, r=st["r"] - a * s,
                    u=st["u"] - a * q, w=st["w"] - a * z,
                    z=z, q=q, s=s, p=p,
                    gamma_old=gamma, alpha_old=alpha, it=st["it"] + 1)

    def make_check_args(s, it):
        return CheckArgs(iteration=it, residual=s["r"])

    final, history = run_iteration_loop(
        step, make_check_args, state, criteria, b2, r0_norm, b_norm,
        trace=trace)
    return finish(final, history, final["state"]["x"], final["state"]["r"],
                  squeeze)


PipeCg = SolverAPI("PipeCg", solve)
