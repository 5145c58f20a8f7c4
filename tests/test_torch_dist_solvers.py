"""Distributed solves (``distributed/``): the
port's Krylov solvers on a ``DistributedMatrix`` against ginkgo_tpu's on
the same numpy inputs, on the CPU, in f64: the reference distributed
solve's iteration count exactly and x to 1e-8.  The port's solvers take
the operator unchanged, as the reference's do."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

import ginkgo_tpu.distributed as jd
import ginkgo_tpu.solver as jsolver
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
import ginkgo_tpu_torch.solver as tsolver
from ginkgo_tpu_torch.distributed import (Partition, distribute_vector,
                                          make_mesh, read_distributed)
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import (generate_random_matrix,
                                               make_spd, stencil_3d)

X_TOL = 1e-8


def systems(data, P):
    """(reference operator, its mesh, port operator, partition)."""
    n = data.shape[0]
    jmesh = JMesh(np.array(jax.devices()[:P]), ("rows",))
    Aj = jd.read_distributed(
        JMatrixData(data.shape, data.row_idx, data.col_idx, data.values),
        jd.Partition.build_from_global_size_uniform(P, n), jmesh)
    part = Partition.build_from_global_size_uniform(P, n)
    At = read_distributed(data, part, make_mesh((P,), ("rows",),
                                                device="cpu"))
    return Aj, jmesh, At, part


def solve_both(data, P, b, name, iters, tol, jprec=None, tprec=None):
    Aj, jmesh, At, part = systems(data, P)
    rj = getattr(jsolver, name).solve(
        Aj, jd.distribute_vector(b, Aj.host_partition, jmesh),
        criteria=JIteration(iters) | JResidualNorm(tol),
        preconditioner=jprec(Aj) if jprec else None)
    rt = getattr(tsolver, name).solve(
        At, distribute_vector(b, part, At.mesh),
        criteria=Iteration(iters) | ResidualNorm(tol),
        preconditioner=tprec(At) if tprec else None)
    assert bool(rt.converged.all())
    assert int(rt.iterations[0]) == int(rj.iterations[0])
    xj = part.from_padded(np.asarray(rj.x))
    xt = part.from_padded(rt.x.numpy())
    assert np.abs(xt - xj).max() <= X_TOL * np.abs(xj).max()
    return rt, part


@pytest.mark.parametrize("name", ["Cg", "PipeCg", "Bicgstab"])
def test_dist_solver_matches_reference(name):
    data = stencil_3d(6, points=7)
    x_true = np.random.default_rng(7).standard_normal(data.shape[0])
    res, part = solve_both(data, 4, data.to_dense() @ x_true, name, 800,
                           1e-11)
    np.testing.assert_allclose(part.from_padded(res.x.numpy()), x_true,
                               rtol=1e-6, atol=1e-7)


def test_dist_jacobi_preconditioned_cg():
    data = make_spd(generate_random_matrix(48, 48, nonzeros_per_row=(2, 6),
                                           seed=17), shift=1.0)
    solve_both(data, 8, np.ones(48), "Cg", 500, 1e-10,
               jprec=lambda A: A.extract_diagonal().inverse(),
               tprec=lambda A: A.extract_diagonal().inverse())
