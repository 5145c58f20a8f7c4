"""Identity operator (``include/ginkgo/core/matrix/identity.hpp:35``).

Implements the scale-add apply(alpha,b,beta,x) = alpha*b+beta*x; also the
default (no-op) preconditioner.
"""

from __future__ import annotations

from ..base.linop import LinOp


class Identity(LinOp):
    def __init__(self, size: int):
        self.size = int(size)

    @property
    def shape(self):
        return (self.size, self.size)

    def _apply(self, b):
        return b

    def _apply_advanced(self, alpha, b, beta, x):
        return alpha * b + beta * x
