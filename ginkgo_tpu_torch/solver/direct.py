"""Direct solver — sparse factorization + triangular solves
(``ginkgo_tpu/solver/direct.py`` in torch).

Analog of ``include/ginkgo/core/solver/direct.hpp:33`` /
``core/solver/direct.cpp``: generate runs the (LU or Cholesky)
factorization once on the host; apply is two triangular solves on the
factors' device, each with the ``algorithm="auto"`` route of
``solver/triangular.py``.
"""

from __future__ import annotations

from ..base.linop import LinOp
from ..factorization.direct import Lu
from .triangular import LowerTrs, UpperTrs


class DirectOp(LinOp):
    def __init__(self, l_solver, u_solver, shape):
        self.l_solver = l_solver
        self.u_solver = u_solver
        self.shape = tuple(shape)

    def _apply(self, b):
        return self.u_solver._apply(self.l_solver._apply(b))

    def solve(self, b):
        return self.apply(b)


class Direct:
    """Factory: ``Direct(factorization=Lu()).generate(A)``."""

    def __init__(self, factorization=None):
        self.factorization = factorization

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> DirectOp:
        fact = self.factorization if self.factorization is not None else Lu()
        if hasattr(fact, "generate"):
            fact = fact.generate(A)
        L, U = fact.unpack()
        return DirectOp(l_solver=LowerTrs.build().generate(L),
                        u_solver=UpperTrs.build().generate(U),
                        shape=fact.shape)
