"""Composite operators (``ginkgo_tpu/base/composition.py`` in torch).

Analog of Ginkgo's ``Composition`` (op1 @ op2 @ ...,
``include/ginkgo/core/base/composition.hpp:39``); the only composite the
ported path needs so far (``Factorization.to_composition``).
"""

from __future__ import annotations

from .linop import LinOp


class Composition(LinOp):
    """x = op_0 @ (op_1 @ (... @ b))."""

    def __init__(self, ops):
        self.ops = tuple(ops)
        for a, b in zip(self.ops[:-1], self.ops[1:]):
            if a.shape[1] != b.shape[0]:
                raise ValueError("non-conformant composition")

    @property
    def shape(self):
        return (self.ops[0].shape[0], self.ops[-1].shape[1])

    def _apply(self, b):
        for op in reversed(self.ops):
            b = op._apply(b)
        return b
