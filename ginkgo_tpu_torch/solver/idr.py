"""IDR(s), induced dimension reduction (``ginkgo_tpu/solver/idr.py`` in
torch).

Analog of ``core/solver/idr.cpp`` (``include/ginkgo/core/solver/idr.hpp:56``):
the biortho IDR(s) variant with the omega angle correction (``kappa``,
default 0.7) and a deterministic random shadow space P: generated on the
host from ``np.random.default_rng(seed)`` exactly as the JAX package does,
so both packages use the same P.

The ``s`` inner steps are an unrolled Python loop (s is tiny, 2-4), each one
SpMV + one preconditioner apply; one loop trip = one full IDR cycle of
``s + 1`` SpMVs.  G and U are lists of s (n, k) vectors in the state, so a
step replaces one of them without copying the others.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.dtypes import is_complex
from ..matrix.dense import compute_conj_dot, compute_norm2
from ..stop.criterion import CheckArgs, default_criterion
from .common import (SolverAPI, finish, prepare_rhs, resolve_precond,
                     run_iteration_loop, safe_div)


def _shadow_space(n, s, dtype, seed, device):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, s))
    if is_complex(dtype):
        P = P + 1j * rng.standard_normal((n, s))
    Q, _ = np.linalg.qr(P)
    # (s, n), rows orthonormal
    return torch.from_numpy(np.ascontiguousarray(Q.conj().T)).to(
        device=device, dtype=dtype)


def solve(A, b, x0=None, *, criteria=None, preconditioner=None,
          subspace_dim: int = 2, kappa: float = 0.7, seed: int = 1729,
          trace: bool = False):
    """Solve A x = b with IDR(s) on the device of A and b."""
    b2, x, squeeze = prepare_rhs(A, b, x0)
    M = resolve_precond(preconditioner, A)
    if criteria is None:
        criteria = default_criterion(b2.dtype)
    n, k = b2.shape
    s = int(subspace_dim)
    dtype, dev = b2.dtype, b2.device
    P = _shadow_space(n, s, dtype, seed, dev)     # (s, n)
    Pc = torch.conj(P)

    r = b2 - A._apply(x)
    eyes = torch.eye(s, dtype=dtype, device=dev)[..., None].expand(s, s, k)
    state = dict(x=x, r=r, G=[torch.zeros_like(b2)] * s,
                 U=[torch.zeros_like(b2)] * s, Mm=eyes,
                 om=torch.ones((k,), dtype=dtype, device=dev))
    b_norm = compute_norm2(b2)
    r0_norm = compute_norm2(r)

    def step(st, active):
        x, r, om = st["x"], st["r"], st["om"]
        G, U, Mm = list(st["G"]), list(st["U"]), st["Mm"]
        f = Pc @ r                                      # (s, k)
        for kk in range(s):
            # c = Mm[kk:, kk:]^-1 f[kk:] by forward substitution (unrolled)
            c = []
            for i in range(kk, s):
                acc = f[i]
                for li, l in enumerate(range(kk, i)):
                    acc = acc - Mm[i, l] * c[li]
                c.append(safe_div(acc, Mm[i, i]))
            v = r
            for li, l in enumerate(range(kk, s)):
                v = v - c[li][None, :] * G[l]
            v = M._apply(v)
            u_k = om[None, :] * v
            for li, l in enumerate(range(kk, s)):
                u_k = u_k + c[li][None, :] * U[l]
            g_k = A._apply(u_k)
            # biorthogonalise against P[:kk]
            for i in range(kk):
                alpha = safe_div(Pc[i] @ g_k, Mm[i, i])
                g_k = g_k - alpha[None, :] * G[i]
                u_k = u_k - alpha[None, :] * U[i]
            G[kk] = g_k
            U[kk] = u_k
            Mm = Mm.clone()
            Mm[kk:, kk] = Pc[kk:] @ g_k                 # (s - kk, k)
            beta = safe_div(f[kk], Mm[kk, kk])
            r = r - beta[None, :] * g_k
            x = x + beta[None, :] * u_k
            if kk + 1 < s:
                f = f.clone()
                f[kk + 1:] -= beta[None, :] * Mm[kk + 1:, kk]
        # enter the next Sonneveld space
        v = M._apply(r)
        t = A._apply(v)
        tr = compute_conj_dot(t, r)
        tt = torch.real(compute_conj_dot(t, t))
        om = safe_div(tr, tt.to(tr.dtype))
        # angle correction (maintain-convergence strategy)
        nr = compute_norm2(r)
        rho = safe_div(torch.abs(tr), torch.sqrt(tt) * nr)
        om = torch.where(rho < kappa,
                         om * safe_div(torch.full_like(rho, kappa), rho), om)
        x = x + om[None, :] * v
        r = r - om[None, :] * t
        return dict(x=x, r=r, G=G, U=U, Mm=Mm, om=om)

    def make_check_args(st, it):
        return CheckArgs(iteration=it, residual=st["r"])

    final, history = run_iteration_loop(
        step, make_check_args, state, criteria, b2, r0_norm, b_norm,
        trace=trace)
    return finish(final, history, final["state"]["x"], final["state"]["r"],
                  squeeze)


Idr = SolverAPI("Idr", solve)
