"""Composite operators (``ginkgo_tpu/base/composition.py`` in torch).

Analogs of Ginkgo's ``Composition`` (op1 @ op2 @ ...,
``include/ginkgo/core/base/composition.hpp:39``), ``Combination``
(sum_i alpha_i * op_i, ``combination.hpp:31``), ``Perturbation``
(I + scalar * basis @ projector^H, ``perturbation.hpp:38``) and
``BlockOperator`` (``block_operator.hpp:76``).
"""

from __future__ import annotations

import torch

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


class Combination(LinOp):
    """x = sum_i coefficients[i] * operators[i] @ b."""

    def __init__(self, coefficients, operators):
        self.coefficients = tuple(coefficients)   # scalars or 0-d tensors
        self.operators = tuple(operators)

    @property
    def shape(self):
        return self.operators[0].shape

    def _apply(self, b):
        out = self.coefficients[0] * self.operators[0]._apply(b)
        for c, op in zip(self.coefficients[1:], self.operators[1:]):
            out = out + c * op._apply(b)
        return out


class Perturbation(LinOp):
    """x = (I + scalar * basis @ projector) @ b."""

    def __init__(self, scalar, basis, projector):
        self.scalar = scalar
        self.basis = basis
        self.projector = projector

    @property
    def shape(self):
        n = self.basis.shape[0]
        return (n, self.projector.shape[1])

    def _apply(self, b):
        return b + self.scalar * self.basis._apply(self.projector._apply(b))


class BlockOperator(LinOp):
    """Block operator from a 2-D grid of LinOps (None = zero block)."""

    def __init__(self, blocks):
        self.blocks = tuple(tuple(row) for row in blocks)

    def _col_sizes(self):
        return [next(row[j] for row in self.blocks
                     if row[j] is not None).shape[1]
                for j in range(len(self.blocks[0]))]

    @property
    def shape(self):
        rows = sum(next(b for b in row if b is not None).shape[0]
                   for row in self.blocks)
        return (rows, sum(self._col_sizes()))

    def _apply(self, b):
        col_offs = [0]
        for s in self._col_sizes():
            col_offs.append(col_offs[-1] + s)
        out_rows = []
        for row in self.blocks:
            acc = None
            for j, op in enumerate(row):
                if op is None:
                    continue
                part = op._apply(b[col_offs[j]:col_offs[j + 1]])
                acc = part if acc is None else acc + part
            out_rows.append(acc)
        return torch.cat(out_rows, dim=0)
