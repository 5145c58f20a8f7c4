"""Chebyshev (semi-)iteration (``ginkgo_tpu/solver/chebyshev.py`` in torch).

Analog of ``core/solver/chebyshev.cpp``
(``include/ginkgo/core/solver/chebyshev.hpp:62``): inner-product-free
polynomial iteration on an eigenvalue enclosure ``foci = (lower, upper)``,
the standard smoother for multigrid on well-conditioned spectra.  Per
iteration: one preconditioner apply + one SpMV, zero reductions (the
residual-norm criterion adds its own reduction only when requested).  The
trip counter ``it`` is a host int; ``alpha`` a 0-d tensor shared by all
columns, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..matrix.dense import compute_norm2
from ..stop.criterion import CheckArgs, default_criterion
from .common import (SolverAPI, finish, prepare_rhs, resolve_precond,
                     run_iteration_loop)


def solve(A, b, x0=None, *, criteria=None, preconditioner=None,
          foci=(0.9, 1.1), trace: bool = False):
    """Solve A x = b with the Chebyshev iteration on the device of A and
    b."""
    b2, x, squeeze = prepare_rhs(A, b, x0)
    M = resolve_precond(preconditioner, A)
    if criteria is None:
        criteria = default_criterion(b2.dtype)

    def scalar(v):
        return torch.tensor(v, dtype=b2.dtype, device=b2.device)

    center = scalar((foci[0] + foci[1]) / 2)
    radius = scalar((foci[1] - foci[0]) / 2)

    r = b2 - A._apply(x)
    state = dict(x=x, r=r, p=torch.zeros_like(r), alpha=scalar(1.0), it=0)
    b_norm = compute_norm2(b2)
    r0_norm = compute_norm2(r)

    def step(s, active):
        z = M._apply(s["r"])
        it = s["it"]
        # beta: 0 at it 0; (radius*alpha)^2/2 at it 1; (radius*alpha/2)^2 after
        half_sq = (radius * s["alpha"] / 2) ** 2
        if it == 0:
            beta = torch.zeros_like(half_sq)
            alpha = 1 / center
        else:
            beta = 2 * half_sq if it == 1 else half_sq
            alpha = 1 / (center - beta / s["alpha"])
        p = z + beta * s["p"]
        q = A._apply(p)
        return dict(x=s["x"] + alpha * p, r=s["r"] - alpha * q, p=p,
                    alpha=alpha, it=it + 1)

    def make_check_args(s, it):
        return CheckArgs(iteration=it, residual=s["r"])

    final, history = run_iteration_loop(
        step, make_check_args, state, criteria, b2, r0_norm, b_norm,
        trace=trace)
    return finish(final, history, final["state"]["x"], final["state"]["r"],
                  squeeze)


Chebyshev = SolverAPI("Chebyshev", solve)
