"""Factorization container (``ginkgo_tpu/factorization/container.py`` in
torch).

Analog of ``include/ginkgo/core/factorization/factorization.hpp:76``: holds
the factors of A ≈ L·U (or L·Lᴴ), unpackable into the individual operators
that the Ilu/Ic preconditioners consume.
"""

from __future__ import annotations

from ..base.composition import Composition
from ..base.linop import LinOp


class Factorization(LinOp):
    """L (unit or general lower) and U (upper) factors; for IC, U = Lᴴ.

    ``route`` names the path that made them where the factory has several
    (ParILUT/ParICT: ``"dia"``, ``"packed"`` or ``"general"``), else None."""

    def __init__(self, l_factor, u_factor, symmetric: bool = False):
        self.l_factor = l_factor
        self.u_factor = u_factor
        self.symmetric = bool(symmetric)
        self.route = None

    @property
    def shape(self):
        return (self.l_factor.shape[0], self.u_factor.shape[1])

    def _apply(self, b):
        return self.l_factor._apply(self.u_factor._apply(b))

    def unpack(self):
        return self.l_factor, self.u_factor

    def to_composition(self) -> Composition:
        return Composition(ops=(self.l_factor, self.u_factor))
