"""Distributed multigrid (``multigrid/distributed_pgm.py``): the port
against ginkgo_tpu on the same numpy inputs, on the CPU, in f64.  The
aggregates index for index, the transfer operators and the coarse
operator exactly, and the standalone MG solve to the reference's
iterations with x to 1e-8 (MG-CG: ``test_torch_dist_multigrid_cg.py``)."""

import jax
import numpy as np
import torch
from jax.sharding import Mesh as JMesh

import ginkgo_tpu.distributed as jd
import ginkgo_tpu.solver as jsolver
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.multigrid.distributed_pgm import DistributedPgm as JDistPgm
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu_torch.distributed import (Partition, distribute_vector,
                                          make_mesh, read_distributed)
from ginkgo_tpu_torch.multigrid import DistributedPgm, MultigridLevel
from ginkgo_tpu_torch.solver import Multigrid
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import stencil_2d

P = 4
X_TOL = 1e-8


def systems(data):
    n = data.shape[0]
    jmesh = JMesh(np.array(jax.devices()[:P]), ("rows",))
    Aj = jd.read_distributed(
        JMatrixData(data.shape, data.row_idx, data.col_idx, data.values),
        jd.Partition.build_from_global_size_uniform(P, n), jmesh)
    part = Partition.build_from_global_size_uniform(P, n)
    At = read_distributed(data, part, make_mesh((P,), ("rows",),
                                                device="cpu"))
    bj = jd.distribute_vector(np.ones(n), Aj.host_partition, jmesh)
    return Aj, bj, At, distribute_vector(np.ones(n), part, At.mesh), part


def test_distributed_pgm_level_matches_reference():
    data = stencil_2d(15, points=5)        # n = 225: pad rows on part 3
    Aj, bj, At, bt, part = systems(data)
    lj, lt = JDistPgm().generate(Aj), DistributedPgm().generate(At)
    assert isinstance(lt, MultigridLevel) and lt.fine_op is At
    assert np.array_equal(lt.restrict.agg.numpy(), np.asarray(lj.restrict.agg))
    assert np.array_equal(lt.prolong.slots.numpy(),
                          np.asarray(lj.prolong.slots))
    assert lt.restrict.shape == lj.restrict.shape
    assert lt.prolong.shape == lj.prolong.shape
    np.testing.assert_array_equal(lt.coarse_op.to_dense().numpy(),
                                  np.asarray(lj.coarse_op.to_dense()))
    r = np.random.default_rng(3).standard_normal((part.padded_size, 2))
    rc = lt.restrict.apply(torch.from_numpy(r))
    np.testing.assert_allclose(rc.numpy(),
                               np.asarray(lj.restrict.apply(r)), rtol=1e-14)
    np.testing.assert_array_equal(lt.prolong.apply(rc).numpy(),
                                  np.asarray(lj.prolong.apply(
                                      np.asarray(rc.numpy()))))
    # deeper levels take plain PGM on the coarse operator
    deeper = DistributedPgm().generate(lt.coarse_op)
    assert deeper.fine_op is lt.coarse_op


def test_distributed_multigrid_solver():
    data = stencil_2d(16, points=5)
    Aj, bj, At, bt, part = systems(data)
    crit = dict(j=JIteration(100) | JResidualNorm(1e-9),
                t=Iteration(100) | ResidualNorm(1e-9))
    mgj = jsolver.Multigrid.build(mg_level=JDistPgm(),
                                  criteria=crit["j"]).generate(Aj)
    mgt = Multigrid.build(mg_level=DistributedPgm(),
                          criteria=crit["t"]).generate(At)
    assert len(mgt.levels) == len(mgj.levels) >= 2
    rj, rt = mgj.solve(bj), mgt.solve(bt)
    assert bool(rt.converged.all())
    assert int(rt.iterations[0]) == int(rj.iterations[0])
    xj, xt = np.asarray(rj.x), rt.x.numpy()
    assert np.abs(xt - xj).max() <= X_TOL * np.abs(xj).max()
    np.testing.assert_allclose(part.from_padded(xt),
                               np.linalg.solve(data.to_dense(),
                                               np.ones(256)),
                               rtol=1e-5, atol=1e-6)
