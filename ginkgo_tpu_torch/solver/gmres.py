"""Restarted GMRES (right-preconditioned) and CB-GMRES
(``ginkgo_tpu/solver/gmres.py`` in torch).

Analog of ``core/solver/gmres.cpp`` and ``core/solver/cb_gmres.cpp``
(compressed Krylov basis via storage accessors,
``core/solver/cb_gmres_accessor.hpp:56-115``).  As in the JAX package:

* the Krylov basis is one (m+1, n, k) store (``krylov_basis.py``), with
  classical Gram-Schmidt and one re-orthogonalisation (CGS2) the default
  ortho method, in blocks of ``OB`` rows (classical within a block,
  modified across blocks); ``cgs`` and ``mgs`` are the other choices;
* the Givens rotations run on (m, k) tensors on the device: the rotation
  recurrence is affine in its running value, so it vectorises as a
  log-depth scan instead of a chain of ``j`` tiny launches;
* the per-column residual estimate ``|g[j+1]|`` feeds the criterion, and
  ``run_restarted_loop`` audits estimate-based stops against the restart's
  true residual.

In torch the Arnoldi index ``j`` is a host int: the ortho loops have host
trip counts, only rows ``<= j`` of the basis are read (rows above hold
the previous cycle's vectors; the JAX package multiplies them by a zero
mask), and the basis is written in place (kernel F on the card), never
copied.  The projection's products run in full f32 whatever the caller set
for TF32.
"""

from __future__ import annotations

import torch

from ..log.profiler_hook import span
from ..matrix.dense import compute_norm2
from ..ops.tri_inv import _full_f32_matmul
from ..stop.criterion import (CheckArgs, as_criterion, default_criterion,
                              has_host_side)
from .common import (SolverAPI, finish, host_read, prepare_rhs,
                     resolve_precond, run_iteration_loop, run_restarted_loop,
                     safe_div)
from .krylov_basis import make_basis

ORTHO_METHODS = ("cgs", "cgs2", "mgs")


def _affine_scan(a, b):
    """Inclusive scan along axis 0 of the maps t -> a_i t + b_i, the later
    map applied after the earlier: returns (A_i, B_i) with
    map_i o ... o map_0 = (t -> A_i t + B_i).  Hillis-Steele doubling,
    ceil(log2(len)) passes."""
    s = 1
    while s < a.shape[0]:
        b = torch.cat([b[:s], a[s:] * b[:-s] + b[s:]])
        a = torch.cat([a[:s], a[s:] * a[:-s]])
        s *= 2
    return a, b


def _dots(blk, w):
    """(size, k) = conj(blk)^T w per column; blk (size, n, k), w (n, k)."""
    if blk.shape[2] == 1:
        return torch.conj(blk[..., 0]) @ w
    return torch.einsum("inr,nr->ir", torch.conj(blk), w)


def _combine(w, h, blk, alpha=-1):
    """w + alpha * sum_i h[i] blk[i] per column."""
    if blk.shape[2] == 1:
        return torch.addmm(w, blk[..., 0].T, h, alpha=alpha)
    return w + alpha * torch.einsum("ir,inr->nr", h, blk)


def solve(A, b, x0=None, *, criteria=None, preconditioner=None,
          krylov_dim: int = 100, ortho: str = "cgs2",
          storage_precision=None, trace: bool = False):
    """Solve A x = b with restarted right-preconditioned GMRES(m) on the
    device of A and b.

    ``storage_precision``: None/'keep' | 'reduce1' | 'reduce2' |
    'integer' | 'int8' | a dtype — the CB-GMRES compressed-basis knob
    (``include/ginkgo/core/solver/cb_gmres.hpp:61``).
    """
    with span("solver.gmres"):
        b2, x, squeeze = prepare_rhs(A, b, x0)
        M = resolve_precond(preconditioner, A)
        if criteria is None:
            criteria = default_criterion(b2.dtype)
        n, k = b2.shape
        m = int(krylov_dim)
        if m < 1:
            raise ValueError(f"krylov_dim must be >= 1, got {krylov_dim}")
        if ortho not in ORTHO_METHODS:
            raise ValueError(f"unknown ortho method {ortho!r}")
        dtype, dev = b2.dtype, b2.device
        OB = min(8, m + 1)
        basis = make_basis(storage_precision, m + 1, n, k, dtype, block=OB,
                           device=dev)
        b_norm = compute_norm2(b2)
        eye_R = torch.eye(m + 1, m, dtype=dtype, device=dev)[..., None].expand(
            m + 1, m, k)

        def restart_fields(x, V_store, sel=None):
            """(Re)initialize the cycle, writing v0 into the EXISTING basis
            store (row 0 of the columns of ``sel`` only, for k > 1)."""
            r = b2 - A._apply(x)
            beta = compute_norm2(r).to(dtype)
            v0 = r * safe_div(torch.ones_like(beta), beta)[None, :]
            V = basis.write(V_store, 0, v0, sel)
            g = torch.zeros((m + 1, k), dtype=dtype, device=dev)
            g[0] = beta
            zeros = torch.zeros((m, k), dtype=dtype, device=dev)
            return dict(x=x, V=V, R=eye_R, g=g, cs=zeros, sn=zeros,
                        j_inner=torch.zeros((k,), dtype=torch.int32,
                                            device=dev),
                        resnorm_est=torch.abs(beta), j=0)

        state0 = restart_fields(x, basis.empty())
        r0_norm = state0["resnorm_est"]

        def project(V_store, w, j):
            """One orthogonalisation pass of w against span(V[0..j]) in blocks
            of OB rows: classical within a block (one batched dot, one batched
            update), modified Gram-Schmidt across blocks."""
            hs = []
            for start in range(0, j + 1, OB):
                size = min(OB, j + 1 - start)
                # (size, n, k)
                blk = basis.read_block(V_store, start, size, dtype)
                hb = _dots(blk, w)
                w = _combine(w, hb, blk)
                hs.append(hb)
            return torch.cat(hs), w                                  # (j+1, k)

        def orthogonalize(V_store, w, j):
            """(h[0..j], w orthogonalised); h is (j+1, k)."""
            if ortho == "mgs":
                hs = []
                for i in range(j + 1):
                    vi = basis.read_one(V_store, i, dtype)
                    hi = torch.sum(torch.conj(vi) * w, dim=0)
                    w = w - hi[None, :] * vi
                    hs.append(hi)
                return torch.stack(hs), w
            with _full_f32_matmul():
                h, w = project(V_store, w, j)
                if ortho == "cgs2":
                    h2, w = project(V_store, w, j)
                    h = h + h2
            return h, w

        def arnoldi_step(s, active=None):
            j = s["j"]
            vj = basis.read_one(s["V"], j, dtype)
            with span("step.precond"):
                z = M._apply(vj)
            with span("step.spmv"):
                w = A._apply(z)
            with span("gmres.project"):
                hcol, w = orthogonalize(s["V"], w, j)                # (j+1, k)
            h_new = compute_norm2(w).to(dtype)
            v_next = w * safe_div(torch.ones_like(h_new), h_new)[None, :]
            with span("gmres.basis_write"):
                V = basis.write(s["V"], j + 1, v_next, active)

            # apply the previous rotations 0..j-1 to the new column: the
            # recurrence t_0 = h[0], t_{i+1} = -sn_i t_i + cs_i h[i+1] is
            # affine in t, so it runs as one log-depth scan; then
            # rotated[i] = conj(cs_i) t_i + sn_i h[i+1] for i < j
            h0 = hcol[0:1]
            if j > 0:
                cs, sn, hb = s["cs"][:j], s["sn"][:j], hcol[1:j + 1]
                acc_a, acc_b = _affine_scan(-sn, cs * hb)
                t = torch.cat([h0, acc_a * h0 + acc_b])              # (j+1, k)
                rotated = torch.conj(cs) * t[:j] + sn * hb
            else:
                t = h0
            # the new rotation annihilates position j+1 (hj = t_j, hj1 = h_new)
            hj = t[j]
            denom = torch.sqrt(torch.abs(hj) ** 2
                               + torch.abs(h_new) ** 2).to(dtype)
            c = torch.where(denom == 0, torch.ones_like(hj),
                            safe_div(hj, denom))
            sg = safe_div(h_new, denom)
            # a fresh tensor (eye_R is an expanded view); column j still
            # holds eye_R's column here
            R = torch.clone(s["R"], memory_format=torch.contiguous_format)
            if j > 0:
                R[:j, j] = rotated
            R[j, j] = denom
            gj = s["g"][j]
            g = s["g"].clone()
            g[j] = torch.conj(c) * gj
            g[j + 1] = -sg * gj
            cs_new, sn_new = s["cs"].clone(), s["sn"].clone()
            cs_new[j] = c
            sn_new[j] = sg
            return dict(x=s["x"], V=V, R=R, g=g, cs=cs_new, sn=sn_new,
                        j_inner=s["j_inner"] + 1,
                        resnorm_est=torch.abs(sg * gj), j=j + 1)

        def solution_update(s):
            """x += M (V[:J] y),  R y = g masked to each column's j_inner;
            J = max j_inner (a frozen column may hold more steps than the
            current cycle's j), and y is 0 from row j_inner on."""
            with span("gmres.update"):
                J = host_read(s["j_inner"].max())
                if J == 0:
                    return s["x"]
                row = torch.arange(J, device=dev)[:, None]
                g_eff = torch.where(row < s["j_inner"][None, :], s["g"][:J],
                                    torch.zeros((), dtype=dtype, device=dev))
                y = torch.linalg.solve_triangular(
                    s["R"][:J, :J].permute(2, 0, 1), g_eff.T[:, :, None],
                    upper=True)[:, :, 0].T                          # (J, k)
                with _full_f32_matmul():
                    u = _combine(torch.zeros_like(s["x"]), y,
                                 basis.read_block(s["V"], 0, J, dtype),
                                 alpha=1)
                with span("step.precond"):
                    du = M._apply(u)
                return s["x"] + du

        def restart(s, sel=None):
            return restart_fields(solution_update(s), s["V"], sel)

        def make_check_args(s, it):
            return CheckArgs(iteration=it, residual_norm=s["resnorm_est"])

        if trace or has_host_side(as_criterion(criteria)):
            # history / wall-clock paths: single-level loop with the restart
            # folded into the same trip as the following arnoldi step, so the
            # iteration counts match the two-level path (restarts are free)
            def step(s, active):
                if s["j"] >= m:
                    with span("loop.restart"):
                        s = restart(s, active)
                return arnoldi_step(s, active)

            final, history = run_iteration_loop(
                step, make_check_args, state0, criteria, b2, r0_norm, b_norm,
                trace=trace)
            xf = solution_update(final["state"])
            rf = b2 - A._apply(xf)
            # post-hoc honesty check: the estimate-based `converged` only
            # stands if the criterion also accepts the TRUE final residual;
            # otherwise the column is reported stagnated
            crit = as_criterion(criteria)
            args = CheckArgs(iteration=final["it"],
                             residual_norm=compute_norm2(rf))
            _, conv_t, _ = crit.check(final["crit"], args)
            est = final["converged"]
            final = dict(final, converged=est & conv_t,
                         stagnated=est & ~conv_t)
        else:
            # hot path: the inner loop runs pure arnoldi steps, the restart
            # once per cycle in the outer loop; mid-cycle estimate-based stops
            # are audited against the restart's true residual
            final, history = run_restarted_loop(
                arnoldi_step, lambda s: s["j"] >= m, restart, make_check_args,
                state0, criteria, b2, r0_norm, b_norm)
            xf = solution_update(final["state"])
            rf = b2 - A._apply(xf)
        return finish(final, history, xf, rf, squeeze)


def solve_cb(A, b, x0=None, *, storage_precision="reduce1", **kw):
    """CB-GMRES: GMRES with a compressed Krylov basis
    (``include/ginkgo/core/solver/cb_gmres.hpp:96``)."""
    return solve(A, b, x0, storage_precision=storage_precision, **kw)


Gmres = SolverAPI("Gmres", solve)
CbGmres = SolverAPI("CbGmres", solve_cb)
