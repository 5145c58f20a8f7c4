"""SOR / Gauss-Seidel preconditioners (``ginkgo_tpu/preconditioner/sor.py``
in torch).

Analog of ``include/ginkgo/core/preconditioner/sor.hpp:51`` /
``gauss_seidel.hpp:33`` (kernels ``common/cuda_hip/preconditioner/
sor_kernels.cpp``): M is composed from triangular parts of A and applied via
the library's level-scheduled triangular solves.

* forward SOR:  M = (1/w) (D + w L)          -> one lower trisolve
* symmetric SOR: M = w/(2-w) (D/w + L) D^-1 (D/w + U)
                 -> lower trisolve, diagonal scale, upper trisolve
* Gauss-Seidel = SOR(w = 1)

The triangular parts are built on the host and placed, with the diagonal,
on A's device (the CUDA device for plain MatrixData); the solves take the
``algorithm="auto"`` route of ``solver/triangular.py`` there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.linop import LinOp
from ..base.matrix_data import MatrixData
from ..device import matrix_data_and_device
from ..matrix.csr import Csr
from ..solver.triangular import LowerTrs, UpperTrs


class SsorApply(LinOp):
    def __init__(self, lower, upper, diag, scale=1.0):
        self.lower = lower
        self.upper = upper
        self.diag = diag        # (n,) on the solves' device
        self.scale = float(scale)

    @property
    def shape(self):
        return self.lower.shape

    def _apply(self, b):
        y = self.lower._apply(b)
        y = self.diag[:, None].to(y.dtype) * y
        y = self.upper._apply(y)
        return y / self.scale


class Sor:
    """Factory: ``Sor(relaxation_factor=1.2, symmetric=False).generate(A)``."""

    def __init__(self, relaxation_factor: float = 1.2,
                 symmetric: bool = False, l_solver=None, u_solver=None):
        if not (0 < relaxation_factor < 2):
            raise ValueError("SOR needs 0 < relaxation_factor < 2")
        self.omega = relaxation_factor
        self.symmetric = symmetric
        self.l_solver = l_solver or LowerTrs.build()
        self.u_solver = u_solver or UpperTrs.build()

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> LinOp:
        data, device = matrix_data_and_device(A)
        d = data.canonical()
        n = d.shape[0]
        w = self.omega
        diag = np.zeros(n, d.values.dtype)
        on = d.row_idx == d.col_idx
        diag[d.row_idx[on]] = d.values[on]
        diag[diag == 0] = 1.0
        lower = d.row_idx > d.col_idx
        upper = d.row_idx < d.col_idx
        idx = np.arange(n)

        def tri(mask, scale_diag):
            return MatrixData(
                (n, n),
                np.concatenate([d.row_idx[mask], idx]),
                np.concatenate([d.col_idx[mask], idx]),
                np.concatenate([d.values[mask], diag * scale_diag]))

        def factor(mask):
            return Csr.from_data(tri(mask, 1.0 / w), strategy="classical",
                                 device=device)

        if not self.symmetric:
            # (D/w + L) x = b
            return self.l_solver.generate(factor(lower))
        return SsorApply(lower=self.l_solver.generate(factor(lower)),
                         upper=self.u_solver.generate(factor(upper)),
                         diag=torch.from_numpy(diag).to(device),
                         scale=w / (2.0 - w))


class GaussSeidel(Sor):
    """Gauss-Seidel = SOR(relaxation_factor=1) (``gauss_seidel.hpp:33``)."""

    def __init__(self, symmetric: bool = False, **kw):
        super().__init__(relaxation_factor=1.0, symmetric=symmetric, **kw)
