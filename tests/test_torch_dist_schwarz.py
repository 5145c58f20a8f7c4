"""The distributed Schwarz preconditioner (``distributed/schwarz.py``)
against ginkgo_tpu's on the same numpy inputs, on the CPU, in f64: the
default dense local solves, per-part ``local_solver`` operators, and the
two-level additive correction over ``DistributedPgm``, each CG taking the
reference's iterations exactly with x to 1e-8."""

import numpy as np
import pytest
import torch

import ginkgo_tpu.distributed as jd
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.multigrid.distributed_pgm import DistributedPgm as JDistPgm
from ginkgo_tpu.preconditioner.ilu import Ilu as JIlu
from ginkgo_tpu.preconditioner.jacobi import Jacobi as JJacobi
from ginkgo_tpu_torch.config import parse
from ginkgo_tpu_torch.distributed import Schwarz
from ginkgo_tpu_torch.multigrid import DistributedPgm
from ginkgo_tpu_torch.preconditioner import Ilu, Jacobi
from ginkgo_tpu_torch.solver import Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import stencil_2d
from test_torch_dist_solvers import solve_both


def test_schwarz_preconditioner():
    """The default dense local solves against the reference's, and the
    serial CG with the same block-diagonal inverse."""
    data = stencil_2d(10, points=5)
    res, part = solve_both(data, 4, np.ones(100), "Cg", 500, 1e-10,
                           jprec=lambda A: jd.Schwarz().generate(A),
                           tprec=lambda A: Schwarz().generate(A))
    dense = data.to_dense()
    np.testing.assert_allclose(part.from_padded(res.x.numpy()),
                               np.linalg.solve(dense, np.ones(100)),
                               rtol=1e-6, atol=1e-7)
    blockinv = np.zeros_like(dense)
    for p in range(4):
        lo, hi = part.ranges[p], part.ranges[p + 1]
        blockinv[lo:hi, lo:hi] = np.linalg.inv(dense[lo:hi, lo:hi])
    serial = Cg.solve(
        gtt.Csr.from_data(data, device="cpu"),
        torch.ones(100, dtype=torch.float64),
        criteria=Iteration(500) | ResidualNorm(1e-10),
        preconditioner=gtt.Dense.create(blockinv, device="cpu"))
    assert abs(int(res.iterations[0]) - int(serial.iterations[0])) <= 1


VARIANTS = {
    "ilu": (lambda: jd.Schwarz(local_solver=JIlu()),
            lambda: Schwarz(local_solver=Ilu())),
    "block_jacobi_two_level": (
        lambda: jd.Schwarz(local_solver=JJacobi(max_block_size=4),
                           coarse_level=JDistPgm()),
        lambda: Schwarz(local_solver=Jacobi(max_block_size=4),
                        coarse_level=DistributedPgm())),
    "dense_two_level": (lambda: jd.Schwarz(coarse_level=JDistPgm()),
                        lambda: Schwarz(coarse_level=DistributedPgm()))}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_schwarz_variants(variant):
    jfac, tfac = VARIANTS[variant]
    data = stencil_2d(12, points=5)
    solve_both(data, 4, np.ones(144), "Cg", 500, 1e-10,
               jprec=lambda A: jfac().generate(A),
               tprec=lambda A: tfac().generate(A))


def test_schwarz_from_config():
    """``preconditioner::Schwarz`` builds the port's factory."""
    fac = parse({"type": "preconditioner::Schwarz"})
    assert isinstance(fac, Schwarz) and fac.local_solver is None
