"""The program's Krylov solvers on a generated matrix, through its public
API: ``Csr.from_data`` on the generated arrays, ``Jacobi().generate(A)``,
and ``Cg.solve`` or ``Gmres.solve`` with ``ResidualNorm | Iteration``."""

from __future__ import annotations

import time

import numpy as np


class System:
    """Set-up once, then ``solve(b)`` per right-hand side (n, k).

    ``spans`` (a dict) receives the seconds of each set-up phase under the
    names the per-layer metrics read: ``import`` (the program's),
    ``from_data`` and ``precond``."""

    def __init__(self, matrix, config: dict, device, spans: dict):
        t = time.perf_counter()
        from ginkgo_tpu_torch import Csr, MatrixData
        from ginkgo_tpu_torch.preconditioner.jacobi import Jacobi
        from ginkgo_tpu_torch.solver import Cg, Gmres
        from ginkgo_tpu_torch.stop.criterion import Iteration, ResidualNorm

        spans["import"] = time.perf_counter() - t
        shape, rows, cols, values = matrix
        self.n, self.nnz = shape[0], len(values)
        self.value_bytes = np.dtype(config["dtype"]).itemsize
        t = time.perf_counter()
        self.A = Csr.from_data(MatrixData(shape, rows, cols, values),
                               dtype=np.dtype(config["dtype"]), device=device)
        spans["from_data"] = time.perf_counter() - t
        t = time.perf_counter()
        precond = config.get("preconditioner")
        if precond not in (None, "jacobi"):
            raise ValueError(f"unknown preconditioner {precond!r}")
        self.M = Jacobi().generate(self.A) if precond == "jacobi" else None
        spans["precond"] = time.perf_counter() - t
        self.criteria = (ResidualNorm(reduction_factor=config["tol"])
                         | Iteration(max_iters=config["max_iters"]))
        solver = config["solver"]
        if solver == "cg":
            self._solve = lambda b: Cg.solve(self.A, b, criteria=self.criteria,
                                             preconditioner=self.M)
        elif solver == "gmres":
            self._solve = lambda b: Gmres.solve(
                self.A, b, criteria=self.criteria, preconditioner=self.M,
                krylov_dim=config["krylov_dim"], ortho=config["ortho"],
                storage_precision=config["storage"])
        else:
            raise ValueError(f"unknown solver {solver!r}")

    def solve(self, b):
        """The program's SolveResult: x (n, k), iterations, converged and
        stagnated per column."""
        return self._solve(b)

    def apply(self, x):
        """The operator's apply at its public boundary."""
        return self.A.apply(x)
