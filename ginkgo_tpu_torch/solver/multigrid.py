"""Multigrid solver / preconditioner (``ginkgo_tpu/solver/multigrid.py``
in torch).

Analog of ``include/ginkgo/core/solver/multigrid.hpp:107`` /
``core/solver/multigrid.cpp``: a level list built from ``MultigridLevel``
factories (PGM by default), V/W/F/K cycles, pre/post smoothers, a
coarsest solver.  The hierarchy is built at generate time; one cycle is a
host recursion over the level list (the reference unrolls it into one XLA
program), each level's SpMVs launching the matrix's kernel.

Usable three ways, as in Ginkgo:
* ``Multigrid.build(...).generate(A)`` -> LinOp whose apply runs ``A⁻¹ b``
  iterating cycles until the criterion fires;
* ``cycle_op = mg.cycle_operator()`` -> one-cycle LinOp (the AMG
  *preconditioner* for CG/GMRES);
* directly as ``preconditioner=`` for any solver (factories are accepted).
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.dtypes import as_torch_dtype
from ..base.linop import LinOp, map_tensors
from ..matrix.dense import compute_norm2
from ..stop.criterion import CheckArgs, default_criterion
from .common import finish, prepare_rhs, run_iteration_loop


class _DampedJacobiSmoother(LinOp):
    """Default smoother: ``iters`` sweeps of omega-damped scalar Jacobi
    (Ginkgo's build_smoother(Jacobi, iterations=2, relaxation=0.9) default,
    multigrid.cpp)."""

    def __init__(self, inv_diag, A, omega: float = 0.9, iters: int = 2):
        self.inv_diag = inv_diag
        self.A = A
        self.omega = omega
        self.iters = iters

    @property
    def shape(self):
        return self.A.shape

    def smooth(self, b, x):
        d = self.inv_diag[:, None].to(b.dtype)
        for _ in range(self.iters):
            x = x + self.omega * d * (b - self.A._apply(x))
        return x

    def _apply(self, b):
        return self.smooth(b, torch.zeros_like(b))


def _default_smoother(A):
    diag = A.extract_diagonal().values
    inv = torch.where(diag == 0, torch.ones_like(diag), 1.0 / diag)
    return _DampedJacobiSmoother(inv, A)


def _smooth(sm, A, b, x):
    """Run a smoother: native .smooth if present, else one correction step
    x + S(b - A x) so any solver/preconditioner LinOp works as a smoother."""
    if hasattr(sm, "smooth"):
        return sm.smooth(b, x)
    return x + sm._apply(b - A._apply(x))


class _CastOp(LinOp):
    """Applies inner then casts — the mixed-multigrid precision boundary."""

    def __init__(self, inner, out_dtype):
        self.inner = inner
        self.out_dtype = out_dtype

    @property
    def shape(self):
        return self.inner.shape

    def _apply(self, b):
        return self.inner._apply(b).to(self.out_dtype)


class _DenseCoarseSolver(LinOp):
    """The coarsest level's inverse, inverted on the host and applied as a
    plain product."""

    def __init__(self, inv):
        self.inv = inv

    @property
    def shape(self):
        return tuple(self.inv.shape)

    def _apply(self, b):
        return torch.matmul(self.inv.to(b.dtype), b)


class MultigridOp(LinOp):
    """Generated multigrid hierarchy; apply = solve to criterion."""

    def __init__(self, levels, smoothers, coarsest, criteria=None,
                 cycle: str = "v"):
        self.levels = tuple(levels)          # of MultigridLevel
        self.smoothers = tuple(smoothers)    # per level
        self.coarsest = coarsest
        self.criteria = criteria
        self.cycle = cycle

    @property
    def shape(self):
        return self.levels[0].fine_op.shape if self.levels else \
            self.coarsest.shape

    # -- one multigrid cycle (a host recursion over the levels) -------------
    def run_cycle(self, b, x, level: int = 0):
        if level >= len(self.levels):
            return self.coarsest._apply(b)
        lvl = self.levels[level]
        sm = self.smoothers[level]
        x = _smooth(sm, lvl.fine_op, b, x)        # pre-smooth
        r = b - lvl.fine_op._apply(x)
        rc = lvl.restrict._apply(r)
        xc = torch.zeros_like(rc)
        if self.cycle == "k" and level + 1 < len(self.levels):
            # K-cycle (Notay): Krylov-accelerated coarse solve — one cycle
            # application plus a minimization step on the coarse system
            xc = self._kcycle_solve(rc, level + 1)
        else:
            xc = self.run_cycle(rc, xc, level + 1)
            if self.cycle == "w" and level + 1 < len(self.levels):
                xc = self.run_cycle(rc, xc, level + 1)
            elif self.cycle == "f" and level + 1 < len(self.levels):
                # F-cycle: after the recursive F, one extra V from here
                xc = self._v_cycle(rc, xc, level + 1)
        x = x + lvl.prolong._apply(xc)            # coarse-grid correction
        x = _smooth(sm, lvl.fine_op, b, x)        # post-smooth
        return x

    def _kcycle_solve(self, b, level):
        """~2 steps of cycle-preconditioned minimization on the level's
        system (the kcycle of multigrid_kernels; simplified steepest
        descent in the cycle-preconditioned direction)."""
        A = self.levels[level].fine_op
        x = self.run_cycle(b, torch.zeros_like(b), level)
        r = b - A._apply(x)
        z = self.run_cycle(r, torch.zeros_like(r), level)
        Az = A._apply(z)
        num = torch.sum(torch.conj(z) * r, dim=0)
        den = torch.sum(torch.conj(z) * Az, dim=0)
        alpha = torch.where(den == 0, torch.zeros_like(num), num /
                            torch.where(den == 0, torch.ones_like(den), den))
        return x + alpha[None, :] * z

    def _v_cycle(self, b, x, level):
        if level >= len(self.levels):
            return self.coarsest._apply(b)
        lvl = self.levels[level]
        sm = self.smoothers[level]
        x = _smooth(sm, lvl.fine_op, b, x)
        r = b - lvl.fine_op._apply(x)
        xc = self._v_cycle(lvl.restrict._apply(r),
                           torch.zeros((lvl.restrict.shape[0], b.shape[1]),
                                       dtype=b.dtype, device=b.device),
                           level + 1)
        x = x + lvl.prolong._apply(xc)
        return _smooth(sm, lvl.fine_op, b, x)

    def cycle_operator(self) -> "MultigridCycleOp":
        """One-cycle LinOp — the AMG preconditioner."""
        return MultigridCycleOp(self)

    # -- solve to criterion --------------------------------------------------
    def solve(self, b, x0=None, *, criteria=None, trace=False):
        A = self.levels[0].fine_op
        b2, x, squeeze = prepare_rhs(A, b, x0)
        crit = criteria if criteria is not None else (
            self.criteria if self.criteria is not None
            else default_criterion(b2.dtype))
        r = b2 - A._apply(x)
        state = dict(x=x, r=r)
        b_norm = compute_norm2(b2)
        r0_norm = compute_norm2(r)

        def step(s, active):
            x = self.run_cycle(b2, s["x"])
            return dict(x=x, r=b2 - A._apply(x))

        def make_check_args(s, it):
            return CheckArgs(iteration=it, residual=s["r"])

        final, history = run_iteration_loop(
            step, make_check_args, state, crit, b2, r0_norm, b_norm,
            trace=trace)
        return finish(final, history, final["state"]["x"],
                      final["state"]["r"], squeeze)

    def _apply(self, b):
        return self.solve(b).x


class MultigridCycleOp(LinOp):
    def __init__(self, mg):
        self.mg = mg

    @property
    def shape(self):
        return self.mg.shape

    def _apply(self, b):
        return self.mg.run_cycle(b, torch.zeros_like(b))


class Multigrid:
    """Factory (``multigrid.hpp`` params): ``mg_level`` (coarsening factory,
    default Pgm), ``max_levels``, ``min_coarse_rows``, ``cycle`` in
    v/w/f/k (k = Krylov-accelerated coarse-grid correction, kcycle),
    ``smoother`` (factory or None for damped Jacobi), ``coarsest_solver``
    (factory or None for dense inverse), ``criteria``, ``coarse_dtype``
    (mixed multigrid: the coarse levels stored and smoothed in it)."""

    def __init__(self, mg_level=None, max_levels: int = 10,
                 min_coarse_rows: int = 16, cycle: str = "v",
                 smoother=None, coarsest_solver=None, criteria=None,
                 coarse_dtype=None):
        if cycle not in ("v", "w", "f", "k"):
            raise ValueError(
                f"unknown multigrid cycle {cycle!r}; expected one of "
                "'v', 'w', 'f', 'k'")
        self.mg_level = mg_level
        self.max_levels = max_levels
        self.min_coarse_rows = min_coarse_rows
        self.cycle = cycle
        self.smoother = smoother
        self.coarsest_solver = coarsest_solver
        self.criteria = criteria
        # mixed-multigrid (mixed-multigrid-solver example): coarse levels
        # stored/smoothed at reduced precision, casts at the transfer ops
        self.coarse_dtype = (None if coarse_dtype is None
                             else as_torch_dtype(coarse_dtype))

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> MultigridOp:
        from ..multigrid.pgm import MultigridLevel, Pgm
        coarsener = self.mg_level if self.mg_level is not None else Pgm()
        levels = []
        smoothers = []
        op = A
        for _ in range(self.max_levels):
            if op.shape[0] <= self.min_coarse_rows:
                break
            lvl = coarsener.generate(op)
            if lvl.coarse_op.shape[0] >= op.shape[0]:
                break   # coarsening stalled
            if self.coarse_dtype is not None:
                cd = self.coarse_dtype
                # the prolongation meets coarse vectors: its values (ones)
                # take the coarse type, and its output is cast back
                P = map_tensors(lvl.prolong, lambda t: t.to(cd)
                                if t.is_floating_point() else t)
                lvl = MultigridLevel(
                    fine_op=lvl.fine_op, coarse_op=lvl.coarse_op.astype(cd),
                    restrict=_CastOp(lvl.restrict, cd),
                    prolong=_CastOp(P, op.dtype), route=lvl.route)
            levels.append(lvl)
            if self.smoother is None:
                smoothers.append(_default_smoother(op))
            else:
                smoothers.append(self.smoother.generate(op))
            op = lvl.coarse_op
        if self.coarsest_solver is None:
            dense = op.to_dense()
            inv = np.linalg.inv(dense.cpu().numpy())
            coarsest = _DenseCoarseSolver(
                torch.from_numpy(inv).to(dense.device))
        else:
            coarsest = self.coarsest_solver.generate(op)
        return MultigridOp(levels, smoothers, coarsest,
                           criteria=self.criteria, cycle=self.cycle)
