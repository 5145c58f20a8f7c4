"""GCR, generalized conjugate residual, restarted
(``ginkgo_tpu/solver/gcr.py`` in torch).

Analog of ``core/solver/gcr.cpp`` (``include/ginkgo/core/solver/gcr.hpp:48``).
Search directions P and their images Q = A P live in two ``KrylovBasis``
stores (k = 1 squeezed 2-D, rows padded to the ortho block), written in
place (kernel F on the card).  Each new q is orthogonalised against the
live directions in blocks of ``OB`` rows.  Restart is an index wrap: GCR
updates x every step, so nothing is reconstructed at the boundary.

As in the port's GMRES, the direction counter ``j`` is a host int and only
the live rows ``< j mod m`` of the stores are read (the JAX package reads
whole blocks and multiplies the stale rows by a zero mask).
"""

from __future__ import annotations

import torch

from ..matrix.dense import compute_conj_dot, compute_norm2
from ..ops.tri_inv import _full_f32_matmul
from ..stop.criterion import CheckArgs, default_criterion
from .common import (SolverAPI, finish, prepare_rhs, resolve_precond,
                     run_iteration_loop, safe_div)
from .gmres import _combine, _dots
from .krylov_basis import KrylovBasis


def solve(A, b, x0=None, *, criteria=None, preconditioner=None,
          krylov_dim: int = 100, trace: bool = False):
    """Solve A x = b with restarted GCR(m) on the device of A and b."""
    b2, x, squeeze = prepare_rhs(A, b, x0)
    M = resolve_precond(preconditioner, A)
    if criteria is None:
        criteria = default_criterion(b2.dtype)
    n, k = b2.shape
    m = int(krylov_dim)
    if m < 1:
        raise ValueError(f"krylov_dim must be >= 1, got {krylov_dim}")
    dtype = b2.dtype
    OB = min(8, m)
    buf = KrylovBasis(m, n, k, dtype, block=OB, device=b2.device)

    def init_state(x):
        # also the audit restart: true r + index reset to 0 (a GCR
        # restart discards the stored directions)
        r = b2 - A._apply(x)
        return dict(x=x, r=r, P=buf.empty(), Q=buf.empty(), j=0)

    state = init_state(x)
    b_norm = compute_norm2(b2)
    r0_norm = compute_norm2(state["r"])

    def step(s, active):
        jm = s["j"] % m                  # restart = index wrap
        p = M._apply(s["r"])
        q = A._apply(p)
        with _full_f32_matmul():
            for start in range(0, jm, OB):
                size = min(OB, jm - start)
                Qb = buf.read_block(s["Q"], start, size, dtype)
                Pb = buf.read_block(s["P"], start, size, dtype)
                bb = _dots(Qb, q)
                q = _combine(q, bb, Qb)
                p = _combine(p, bb, Pb)
        nq = compute_norm2(q).to(dtype)
        inv = safe_div(torch.ones_like(nq), nq)[None, :]
        q = q * inv
        p = p * inv
        alpha = compute_conj_dot(q, s["r"])[None, :]
        return dict(x=s["x"] + alpha * p, r=s["r"] - alpha * q,
                    P=buf.write(s["P"], jm, p, active),
                    Q=buf.write(s["Q"], jm, q, active), j=s["j"] + 1)

    def make_check_args(s, it):
        return CheckArgs(iteration=it, residual=s["r"])

    final, history = run_iteration_loop(
        step, make_check_args, state, criteria, b2, r0_norm, b_norm,
        trace=trace, restart_fn=lambda s: init_state(s["x"]))
    return finish(final, history, final["state"]["x"], final["state"]["r"],
                  squeeze)


Gcr = SolverAPI("Gcr", solve)
