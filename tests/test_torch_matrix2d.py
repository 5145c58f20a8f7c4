"""2-D block-distributed operator (``distributed/matrix2d.py``): the cases
of ``tests/test_matrix2d.py``, the port against ginkgo_tpu on the same
numpy inputs (its meshes: 4x2 / 2x4 / 2x2 grids of the 8 virtual CPU
devices; the port's: the same grids of parts on the host).  Blocks
element for element, SpMV and solves to the reference's results, and the
reference's shape errors."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

import ginkgo_tpu.distributed as jd
import ginkgo_tpu.solver as jsolver
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu_torch.base.exceptions import ValueMismatch
from ginkgo_tpu_torch.base.matrix_data import MatrixData
from ginkgo_tpu_torch.distributed import (Mesh, Partition,
                                          distribute_vector_2d, make_mesh,
                                          read_distributed_2d)
from ginkgo_tpu_torch.solver import Bicgstab, Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import (generate_random_matrix,
                                               stencil_3d)


def jmesh(pr, pc):
    return JMesh(np.array(jax.devices()[:pr * pc]).reshape(pr, pc),
                 ("rows", "cols"))


def tmesh(pr, pc):
    return make_mesh((pr, pc), ("rows", "cols"), device="cpu")


def both(data, pr, pc, col_parts=None):
    n = data.shape[0]
    jrp = jd.Partition.build_from_global_size_uniform(pr, n)
    rp = Partition.build_from_global_size_uniform(pr, n)
    kw_j, kw_t = {}, {}
    if col_parts:
        kw_j["col_partition"] = jd.Partition.build_from_global_size_uniform(
            col_parts, n)
        kw_t["col_partition"] = Partition.build_from_global_size_uniform(
            col_parts, n)
    Aj = jd.read_distributed_2d(
        JMatrixData(data.shape, data.row_idx, data.col_idx, data.values),
        jrp, jmesh(pr, pc), **kw_j)
    At = read_distributed_2d(data, rp, tmesh(pr, pc), **kw_t)
    for name in ("blk_rows", "blk_cols", "blk_vals"):
        assert np.array_equal(getattr(At, name).numpy(),
                              np.asarray(getattr(Aj, name))), name
    assert (At.shape, At.global_shape, At.local_nr, At.local_nc) == (
        Aj.shape, Aj.global_shape, Aj.local_nr, Aj.local_nc)
    return Aj, At, rp, kw_t.get("col_partition", rp)


@pytest.mark.parametrize("grid", [(2, 4), (4, 2), (2, 2)])
def test_spmv_matches_serial(grid):
    pr, pc = grid
    data = stencil_3d(8, points=27)
    n = data.shape[0]
    Aj, At, rp, cp = both(data, pr, pc, col_parts=pc)
    x = np.random.default_rng(0).standard_normal((n, 2))
    y = At.apply(distribute_vector_2d(x, cp, At.mesh, axis="cols"))
    yj = np.asarray(Aj.apply(jd.distribute_vector_2d(
        x, Aj.col_partition, jmesh(pr, pc), axis="cols")))
    want = data.to_dense() @ x
    np.testing.assert_allclose(rp.from_padded(y.numpy()), want, rtol=1e-11,
                               atol=1e-11)
    np.testing.assert_allclose(y.numpy(), yj, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(At.to_dense().numpy(),
                                  np.asarray(Aj.to_dense()))


def _solve(name, data, Aj, At, cp, pr, pc, crit):
    n = data.shape[0]
    bj = jd.distribute_vector_2d(np.ones(n), Aj.col_partition,
                                 jmesh(pr, pc), axis="cols")
    rj = getattr(jsolver, name).solve(
        Aj, bj, criteria=JIteration(crit[0]) | JResidualNorm(crit[1]))
    rt = {"Cg": Cg, "Bicgstab": Bicgstab}[name].solve(
        At, distribute_vector_2d(np.ones(n), cp, At.mesh, axis="cols"),
        criteria=Iteration(crit[0]) | ResidualNorm(crit[1]))
    assert bool(rt.converged.all())
    assert int(rt.iterations[0]) == int(rj.iterations[0])
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() <= 1e-8 * np.abs(xj).max()
    return rt


def test_cg_solve_through_2d_operator():
    data = stencil_3d(8, points=27)
    Aj, At, rp, cp = both(data, 2, 4, col_parts=4)
    assert rp.padded_size == cp.padded_size == 512
    _solve("Cg", data, Aj, At, cp, 2, 4, (2000, 1e-12))


def test_bicgstab_nonsymmetric_2d():
    n = 120
    rng = np.random.default_rng(1)
    data = generate_random_matrix(n, n, nonzeros_per_row=(2, 5), seed=1)
    dense = data.to_dense() + np.diag(6 + rng.uniform(0, 1, n))
    data = MatrixData.from_dense(dense)
    Aj, At, rp, cp = both(data, 2, 2)
    res = _solve("Bicgstab", data, Aj, At, cp, 2, 2, (2000, 1e-11))
    x = rp.from_padded(res.x.numpy())
    np.testing.assert_allclose(dense @ x.ravel(), np.ones(n), rtol=1e-7,
                               atol=1e-7)


def test_padded_sizes_work_when_they_agree():
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((7, 7))
    dense[np.abs(dense) < 0.5] = 0.0
    dense = 0.5 * (dense + dense.T)
    np.fill_diagonal(dense, 4.0)
    data = MatrixData.from_dense(dense)
    Aj, At, rp, cp = both(data, 2, 4, col_parts=4)
    assert At.shape == (8, 8) and At.global_shape == (7, 7)
    np.testing.assert_allclose(At.to_dense().numpy(), dense, rtol=1e-14)
    res = Cg.solve(At, distribute_vector_2d(np.ones(7), cp, At.mesh,
                                            axis="cols"),
                   criteria=Iteration(200) | ResidualNorm(1e-12))
    x = rp.from_padded(res.x.numpy())
    np.testing.assert_allclose(dense @ x.ravel(), np.ones(7), rtol=1e-9)


def test_mismatched_padded_sizes_raise():
    data = stencil_3d(7, points=7)
    rp = Partition.build_from_contiguous([0, 115, 230, 343])
    cp = Partition.build_from_global_size_uniform(2, 343)
    with pytest.raises(ValueMismatch, match="padded"):
        read_distributed_2d(data, rp, tmesh(3, 2), col_partition=cp)


def test_mesh_shape_validation():
    data = stencil_3d(4, points=7)
    rp = Partition.build_from_global_size_uniform(4, 64)
    with pytest.raises(ValueError, match="mesh axes"):
        read_distributed_2d(data, rp, tmesh(2, 4))
    with pytest.raises(ValueError, match="mesh axes"):
        read_distributed_2d(data, rp, Mesh(np.array(["cpu"] * 4), ("rows",)))
