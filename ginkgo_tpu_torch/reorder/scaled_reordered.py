"""ScaledReordered — apply reordering/scaling around an inner operator
(``ginkgo_tpu/reorder/scaled_reordered.py`` in torch).

Analog of ``include/ginkgo/core/reorder/scaled_reordered.hpp``: wraps an
inner solver so that solves of A x = b happen in the reordered/scaled basis
(e.g. Mc64-stabilised LU, reordered-preconditioned-solver example):

    A' = R_s P A Pᵀ C_s,  solve A' y = R_s P b,  x = Pᵀ C_s y

The reordering and the scaled matrix are built on the host; the operator
and the inner solver live on A's device.
"""

from __future__ import annotations

import numpy as np

from ..base.linop import LinOp
from ..device import matrix_data_and_device
from ..matrix.csr import Csr
from ..matrix.permutation import (Permutation, ScaledPermutation, _host,
                                  permute_data, permute_mode)
from .rcm import Rcm


class ScaledReorderedOp(LinOp):
    def __init__(self, inner, perm, perm_inv, shape):
        self.inner = inner
        self.perm = perm            # Permutation / ScaledPermutation (rows)
        self.perm_inv = perm_inv
        self.shape = tuple(shape)

    def _apply(self, b):
        y = self.perm._apply(b)
        y = self.inner._apply(y)
        return self.perm_inv._apply(y)


class ScaledReordered:
    """Factory: ``ScaledReordered(inner_operator=solver_factory,
    reordering=Rcm.build()).generate(A)``."""

    def __init__(self, inner_operator, reordering=None):
        self.inner_operator = inner_operator
        self.reordering = reordering

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def _inner(self, A_prime):
        inner = self.inner_operator
        return inner.generate(A_prime) if hasattr(inner, "generate") \
            else inner

    def generate(self, A) -> ScaledReorderedOp:
        data, device = matrix_data_and_device(A)
        reorder = self.reordering if self.reordering is not None \
            else Rcm.build()
        P = reorder.generate(A) if hasattr(reorder, "generate") else reorder
        perm_idx = _host(P.perm)
        scale = _host(getattr(P, "scale", np.ones(len(perm_idx))))
        col_scale = getattr(P, "col_scale", None)
        shape = (data.shape[0], data.shape[1])
        if col_scale is not None:
            # two-sided result (Mc64): A' = S_r P A C_s — rows permuted
            # and scaled, columns scaled in place.  Solve A x = b as
            # A' y = S_r P b with x = C_s y (scaled_reordered.hpp's
            # Composition branch).
            cs = _host(col_scale)
            d = permute_data(data, perm_idx, permute_mode.rows)
            d.values = d.values * scale[d.row_idx] * cs[d.col_idx]
            return ScaledReorderedOp(
                inner=self._inner(Csr.from_data(d, device=device)),
                perm=ScaledPermutation.from_indices(perm_idx, scale,
                                                    device=device),
                perm_inv=ScaledPermutation.from_indices(
                    np.arange(len(cs)), cs, device=device),
                shape=shape)
        # symmetric permutation + row scaling: A' = S P A Pᵀ
        d = permute_data(data, perm_idx, permute_mode.symmetric)
        d.values = d.values * scale[d.row_idx]
        return ScaledReorderedOp(
            inner=self._inner(Csr.from_data(d, device=device)), perm=P,
            perm_inv=Permutation.from_indices(perm_idx,
                                              device=device).inverse(),
            shape=shape)
