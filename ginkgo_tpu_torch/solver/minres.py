"""MINRES for symmetric (possibly indefinite) and Hermitian systems
(``ginkgo_tpu/solver/minres.py`` in torch).

Analog of ``core/solver/minres.cpp`` (``include/ginkgo/core/solver/minres.hpp:57``).
Preconditioned Lanczos three-term recurrence with a running Givens QR of the
tridiagonal; ``phibar`` tracks the M-norm of the residual implicitly, so the
loop is one SpMV + one preconditioner apply + two dots with no true
residual ever formed (it is reconstructed once after the loop).
"""

from __future__ import annotations

import torch

from ..matrix.dense import compute_conj_dot, compute_norm2
from ..stop.criterion import CheckArgs, default_criterion
from .common import (SolverAPI, finish, prepare_rhs, resolve_precond,
                     run_iteration_loop, safe_div)


def solve(A, b, x0=None, *, criteria=None, preconditioner=None,
          trace: bool = False):
    """Solve A x = b (A symmetric/Hermitian) with MINRES on the device of A
    and b."""
    b2, x, squeeze = prepare_rhs(A, b, x0)
    M = resolve_precond(preconditioner, A)
    if criteria is None:
        criteria = default_criterion(b2.dtype)

    dtype = b2.dtype
    ones = torch.ones((b2.shape[1],), dtype=dtype, device=b2.device)
    zeros_s = torch.zeros_like(ones)

    def init_state(x):
        # also the audit restart: a fresh Lanczos process from the true
        # residual (phibar restarts at ||r||_M, the recurrent estimate)
        r0 = b2 - A._apply(x)
        y = M._apply(r0)
        beta1 = torch.sqrt(torch.abs(compute_conj_dot(r0, y))).to(dtype)
        z = torch.zeros_like(b2)
        return dict(x=x, y=y, r1=z, r2=r0, w=z, w2=z,
                    oldb=ones, beta=beta1, dbar=zeros_s, epsln=zeros_s,
                    phibar=beta1, cs=-ones, sn=zeros_s)

    state = init_state(x)
    b_norm = compute_norm2(b2)
    r0_norm = compute_norm2(state["r2"])        # r2 starts as b - A x

    def step(s, active):
        # --- preconditioned Lanczos step ---
        v = s["y"] * safe_div(torch.ones_like(s["beta"]), s["beta"])[None, :]
        y = A._apply(v)
        y = y - safe_div(s["beta"], s["oldb"])[None, :] * s["r1"]
        alfa = compute_conj_dot(v, y)
        y = y - safe_div(alfa, s["beta"])[None, :] * s["r2"]
        r1, r2 = s["r2"], y
        y = M._apply(r2)
        oldb = s["beta"]
        beta = torch.sqrt(torch.abs(compute_conj_dot(r2, y))).to(alfa.dtype)
        # --- Givens QR of the growing tridiagonal ---
        oldeps = s["epsln"]
        delta = s["cs"] * s["dbar"] + s["sn"] * alfa
        gbar = s["sn"] * s["dbar"] - s["cs"] * alfa
        epsln = s["sn"] * beta
        dbar = -s["cs"] * beta
        gamma = torch.sqrt(torch.abs(gbar) ** 2
                           + torch.abs(beta) ** 2).to(alfa.dtype)
        cs = safe_div(gbar, gamma)
        sn = safe_div(beta, gamma)
        phi = cs * s["phibar"]
        phibar = sn * s["phibar"]
        # --- solution update ---
        w1, w2 = s["w2"], s["w"]
        w = (v - oldeps[None, :] * w1 - delta[None, :] * w2) \
            * safe_div(torch.ones_like(gamma), gamma)[None, :]
        x = s["x"] + phi[None, :] * w
        return dict(x=x, y=y, r1=r1, r2=r2, w=w, w2=w2, oldb=oldb, beta=beta,
                    dbar=dbar, epsln=epsln, phibar=phibar, cs=cs, sn=sn)

    def make_check_args(s, it):
        return CheckArgs(iteration=it, residual_norm=torch.abs(s["phibar"]))

    final, history = run_iteration_loop(
        step, make_check_args, state, criteria, b2, r0_norm, b_norm,
        trace=trace, restart_fn=lambda s: init_state(s["x"]))
    xf = final["state"]["x"]
    rf = b2 - A._apply(xf)
    return finish(final, history, xf, rf, squeeze)


Minres = SolverAPI("Minres", solve)
