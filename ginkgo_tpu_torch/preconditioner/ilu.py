"""ILU / IC apply preconditioners (``ginkgo_tpu/preconditioner/ilu.py`` in
torch).

Analog of ``include/ginkgo/core/preconditioner/ilu.hpp:114`` / ``ic.hpp:109``:
couples the L/U (or L/Lᴴ) triangular solves from a factorization into
``M⁻¹ = U⁻¹ L⁻¹``.  The ``l_solver``/``u_solver`` factories default to
``LowerTrs``/``UpperTrs`` with ``algorithm='auto'``; any solver factory
with a ``generate`` may take their place.
"""

from __future__ import annotations

from ..base.linop import LinOp
from ..solver.triangular import LowerTrs, UpperTrs


class IluApply(LinOp):
    """Generated ILU preconditioner: x = U⁻¹ (L⁻¹ b)."""

    def __init__(self, l_solver, u_solver, shape):
        self.l_solver = l_solver
        self.u_solver = u_solver
        self.shape = tuple(shape)

    def _apply(self, b):
        return self.u_solver._apply(self.l_solver._apply(b))


class _FactorPreconditioner:
    """Shared factory of Ilu and Ic: generate the factorization (unless
    one was given), then one triangular solve per factor."""

    default_factorization = None

    def __init__(self, factorization=None, l_solver=None, u_solver=None):
        self.factorization = factorization
        self.l_solver = l_solver
        self.u_solver = u_solver

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> IluApply:
        fact = self.factorization
        if fact is None:
            fact = self.default_factorization()
        if hasattr(fact, "generate"):
            fact = fact.generate(A)
        L, U = fact.unpack()
        lf = self.l_solver if self.l_solver is not None else LowerTrs.build()
        uf = self.u_solver if self.u_solver is not None else UpperTrs.build()
        return IluApply(l_solver=lf.generate(L), u_solver=uf.generate(U),
                        shape=fact.shape)


class Ilu(_FactorPreconditioner):
    """Factory: ``Ilu(factorization=ParIlu()).generate(A)``.

    ``factorization``: a factorization factory (ParIlu/Ilu0/ParIlut) or
    an already-generated Factorization; defaults to exact ILU(0).
    """

    @staticmethod
    def default_factorization():
        from ..factorization.par_ilu import Ilu0
        return Ilu0()


class Ic(_FactorPreconditioner):
    """Factory: IC preconditioner M⁻¹ = L⁻ᴴ L⁻¹ (``ic.hpp:109``;
    ``u_solver`` is the reference's lh_solver slot).  ``factorization``:
    ParIc/Ic0/ParIct or a generated Factorization; defaults to exact
    IC(0)."""

    @staticmethod
    def default_factorization():
        from ..factorization.par_ilu import Ic0
        return Ic0()
