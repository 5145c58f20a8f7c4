"""GMRES and CB-GMRES in f64: the port against ginkgo_tpu on the same
operators and right-hand sides (made with numpy from a seed).

Per column, ``iterations``, ``converged`` and ``stagnated`` must be equal
and x must agree to rtol 1e-10: the port sums in another order (torch's
matmuls against XLA's einsums, a Hillis-Steele scan of the Givens
recurrence against ``associative_scan``), nothing else differs.  Every
store is held to that, the coarse ``reduce2`` (bf16 for f64 values) and
``int8`` included: a last-bit difference could move an entry across a
rounding boundary of the store, but on these inputs none does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.preconditioner.jacobi import Jacobi as JJacobi
from ginkgo_tpu.solver import CbGmres as JCbGmres
from ginkgo_tpu.solver import Gmres as JGmres
from ginkgo_tpu.solver import krylov_basis as jkb
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu.utils.generators import generate_random_matrix, make_spd
from ginkgo_tpu_torch.base.dtypes import reduce_precision
from ginkgo_tpu_torch.ops import row_write
from ginkgo_tpu_torch.preconditioner import Jacobi
from ginkgo_tpu_torch.solver import CbGmres, Gmres
from ginkgo_tpu_torch.solver import krylov_basis as tkb
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils import generators as tgen

def _nonsym_dense(n=40, seed=7):
    """The reference tests' ``_nonsym``: random pattern, diagonally
    dominant."""
    data = generate_random_matrix(n, n, nonzeros_per_row=(2, 6), seed=seed)
    dense = data.to_dense()
    dense += np.diag(np.abs(dense).sum(1) + 1.0)
    return dense


def _both(dense):
    """(JAX Csr, port Csr on the CPU) of one dense matrix."""
    Aj = gt.Csr.from_dense(dense)
    At = gtt.Csr.from_data(gtt.MatrixData.from_dense(dense), device="cpu")
    return Aj, At


def _from_data(d):
    Aj = gt.Csr.from_data(gt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                        d.values))
    At = gtt.Csr.from_data(gtt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                          d.values), device="cpu")
    return Aj, At


def _solve_both(Aj, At, b, max_iters, goal, *, jprec=None, tprec=None,
                cb=False, **kw):
    js, ts = (JCbGmres, CbGmres) if cb else (JGmres, Gmres)
    rj = js.solve(Aj, jnp.asarray(b), criteria=JIteration(max_iters)
                  | JResidualNorm(goal), preconditioner=jprec, **kw)
    rt = ts.solve(At, torch.from_numpy(b), criteria=Iteration(max_iters)
                  | ResidualNorm(goal), preconditioner=tprec, **kw)
    return rj, rt


def _true_rel(dense, b, x):
    b2, x2 = b.reshape(b.shape[0], -1), x.reshape(x.shape[0], -1)
    return (np.linalg.norm(b2 - dense @ x2, axis=0)
            / np.linalg.norm(b2, axis=0))


def _assert_same(rt, rj):
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.stagnated.numpy(),
                                  np.asarray(rj.stagnated))
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=1e-10,
                               atol=1e-10 * float(np.abs(xj).max()))


@pytest.mark.parametrize("storage", ["keep", "reduce1", "reduce2", "integer",
                                     "int8", "float32"])
@pytest.mark.parametrize("ortho", ["cgs", "cgs2", "mgs"])
def test_ortho_and_storage_match_jax(ortho, storage):
    """Restarted (krylov_dim 10) CB-GMRES, two columns that converge at
    different iterations; every storage the reference accepts (an explicit
    dtype is the last)."""
    dense = _nonsym_dense(40, seed=29)
    Aj, At = _both(dense)
    rng = np.random.default_rng(3)
    b = np.stack([dense @ rng.standard_normal(40),
                  rng.standard_normal(40)], axis=1)
    goal = 1e-8
    rj, rt = _solve_both(Aj, At, b, 400, goal, cb=True, krylov_dim=10,
                         ortho=ortho, storage_precision=storage)
    assert bool(np.asarray(rj.converged).all())
    _assert_same(rt, rj)
    assert np.all(_true_rel(dense, b, rt.x.numpy()) <= goal)


@pytest.mark.parametrize("kdim", [4, 7, 10, 100])
def test_restarts_match_jax(kdim):
    dense = _nonsym_dense(50, seed=11)
    Aj, At = _both(dense)
    b = np.random.default_rng(kdim).standard_normal((50, 1))
    rj, rt = _solve_both(Aj, At, b, 2000, 1e-10, krylov_dim=kdim)
    assert bool(np.asarray(rj.converged).all())
    _assert_same(rt, rj)


def test_single_rhs_vector_and_default_solver_match_jax():
    """A rank-1 right-hand side and every default (criteria, krylov_dim,
    ortho, storage) on the 27-point stencil."""
    Aj, At = _from_data(tgen.stencil_3d(8, points=27))
    b = np.random.default_rng(5).standard_normal(512)
    rj = JGmres.solve(Aj, jnp.asarray(b))
    rt = Gmres.solve(At, torch.from_numpy(b))
    assert rt.x.shape == (512,)
    _assert_same(rt, rj)


def test_spd_and_jacobi_match_jax():
    data = make_spd(generate_random_matrix(40, 40, nonzeros_per_row=(2, 6),
                                           seed=41), shift=1.0)
    Aj, At = _from_data(data)
    b = np.random.default_rng(43).standard_normal((40, 2))
    _assert_same(*reversed(_solve_both(Aj, At, b, 300, 1e-12)))
    dense = _nonsym_dense(60, seed=13)
    Aj, At = _both(dense)
    b = np.random.default_rng(13).standard_normal((60, 1))
    rj, rt = _solve_both(Aj, At, b, 500, 1e-11, jprec=JJacobi(),
                         tprec=Jacobi(), krylov_dim=8)
    _assert_same(rt, rj)


def test_multi_rhs_freeze_across_restarts_matches_jax():
    """Columns converging at very different iterations (an eigenvector
    right-hand side, a random one) keep consistent frozen states across
    restarts at krylov_dim 4."""
    rng = np.random.default_rng(47)
    n = 40
    data = generate_random_matrix(n, n, nonzeros_per_row=(2, 5), seed=47)
    dense = data.to_dense()
    dense += np.diag(np.abs(dense).sum(1) + 1.0)
    Aj, At = _both(dense)
    _, eigvecs = np.linalg.eig(dense)
    b = np.stack([np.real(eigvecs[:, 0]), rng.standard_normal(n)], axis=1)
    rj, rt = _solve_both(Aj, At, b, 3000, 1e-10, krylov_dim=4)
    assert int(rt.iterations[0]) < int(rt.iterations[1])
    _assert_same(rt, rj)
    assert np.all(_true_rel(dense, b, rt.x.numpy()) <= 1e-8)


def test_multi_rhs_verification_freeze_matches_jax():
    """Verification reactivation does not corrupt verified columns."""
    rng = np.random.default_rng(53)
    dense = _nonsym_dense(48, seed=53)
    Aj, At = _both(dense)
    x_true = np.random.default_rng(54).standard_normal(48)
    b = np.stack([dense @ x_true, rng.standard_normal(48)], axis=1)
    rj, rt = _solve_both(Aj, At, b, 2000, 1e-10, krylov_dim=6)
    _assert_same(rt, rj)
    assert np.all(_true_rel(dense, b, rt.x.numpy()) <= 1e-9)


def test_cap_stopped_column_keeps_its_basis():
    """A column stopped by the iteration cap while another column's
    estimate-based stop is audited by a restart: the restart writes row 0
    of the audited column only, and the capped column's solution update
    still uses its own basis (the reference threads the basis
    functionally, so it agrees)."""
    dense = _nonsym_dense(60, seed=29)
    Aj, At = _both(dense)
    _, eigvecs = np.linalg.eig(dense)
    rng = np.random.default_rng(8)
    b = np.stack([np.real(eigvecs[:, 0]), rng.standard_normal(60)], axis=1)
    rj, rt = _solve_both(Aj, At, b, 10, 1e-10, krylov_dim=30)
    np.testing.assert_array_equal(np.asarray(rj.converged), [True, False])
    np.testing.assert_array_equal(np.asarray(rj.iterations), [2, 10])
    _assert_same(rt, rj)


def test_unattainable_goal_reports_stagnation_like_jax():
    """An f16 (reduce2 of f64 -> bf16) store cannot reach 1e-12: the
    estimate dips below the goal, the audit contradicts it, the retries
    run out and the column reports stagnated, as in the reference."""
    dense = _nonsym_dense(60, seed=29)
    Aj, At = _both(dense)
    b = np.asarray(Aj.apply(jnp.asarray(
        np.random.default_rng(30).standard_normal(60))))[:, None]
    rj, rt = _solve_both(Aj, At, b, 400, 1e-12, cb=True, krylov_dim=15,
                         storage_precision="reduce1")
    np.testing.assert_array_equal(rt.stagnated.numpy(),
                                  np.asarray(rj.stagnated))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))


@pytest.mark.parametrize("kdim", [5, 8])
def test_trace_history_matches_jax_and_hot_path(kdim):
    dense = _nonsym_dense(50, seed=31)
    Aj, At = _both(dense)
    b = np.random.default_rng(31).standard_normal((50, 2))
    rj, rt = _solve_both(Aj, At, b, 300, 1e-9, krylov_dim=kdim, trace=True)
    hj = np.asarray(rj.resnorm_history)
    ht = rt.resnorm_history.numpy()
    assert ht.shape == hj.shape == (301, 2)
    np.testing.assert_allclose(ht, hj, rtol=1e-9, atol=1e-14)
    _assert_same(rt, rj)
    hot = Gmres.solve(At, torch.from_numpy(b), krylov_dim=kdim,
                      criteria=Iteration(300) | ResidualNorm(1e-9))
    np.testing.assert_array_equal(hot.iterations.numpy(),
                                  rt.iterations.numpy())


def test_factory_surface_and_krylov_dim_zero_raises():
    dense = _nonsym_dense(16, seed=4)
    _, At = _both(dense)
    b = torch.ones(16, dtype=torch.float64)
    with pytest.raises(ValueError, match="krylov_dim"):
        Gmres.solve(At, b, krylov_dim=0)
    with pytest.raises(ValueError, match="ortho"):
        Gmres.solve(At, b, ortho="householder")
    solver = CbGmres.build(criteria=Iteration(200) | ResidualNorm(1e-10),
                           storage_precision="integer").generate(At)
    x = solver.apply(b)
    assert float((b - At.apply(x)).norm()) < 1e-8


@pytest.mark.parametrize("storage", ["keep", "reduce1", "reduce2", "integer",
                                     "int8", np.float32])
@pytest.mark.parametrize("k", [1, 3])
def test_basis_store_equals_jax_after_one_write(storage, k):
    """Every store of the port is the reference's bit for bit after a
    write (bf16 compared through float32: numpy has no bf16; both
    frameworks round to nearest even)."""
    rng = np.random.default_rng(k)
    vec = rng.standard_normal((100, k)) * np.array([1.0, 0.0, 3e-3])[:k]
    jb = jkb.make_basis(storage, 5, 100, k, jnp.float64, block=4)
    tb = tkb.make_basis(storage, 5, 100, k, torch.float64, block=4,
                        device="cpu")
    js = jb.write(jb.empty(), 2, jnp.asarray(vec))
    ts = tb.write(tb.empty(), 2, torch.from_numpy(vec))
    for name in (("q", "scale") if isinstance(ts, dict) else (None,)):
        a = np.asarray(js[name] if name else js)
        t = ts[name] if name else ts
        assert tuple(t.shape) == a.shape
        if t.dtype == torch.bfloat16:
            t, a = t.float(), a.astype(np.float32)
        np.testing.assert_array_equal(t.numpy(), a)
    np.testing.assert_array_equal(
        tb.read_one(ts, 2, torch.float64).numpy(),
        np.asarray(jb.read_one(js, 2, jnp.float64)))


def test_bf16_rounding_matches_jax():
    x = np.random.default_rng(0).standard_normal(4096) * 10.0 ** np.arange(
        -8, 8, 1 / 256)
    got = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))
    np.testing.assert_array_equal(got, want)
    assert reduce_precision(torch.float64) == torch.float32
    assert reduce_precision("float32") == torch.bfloat16
    assert reduce_precision(torch.complex128) == torch.complex64


def test_row_write_in_place_and_masked():
    """The basis write mutates the store it is given; with a selection
    (k > 1) unselected columns keep their rows; the wrapper takes the
    plain version on the CPU and counts no launch there."""
    before = row_write.row_write_cuda.launches
    store = torch.full((6, 10, 3), 7.0, dtype=torch.float64)
    basis = tkb.KrylovBasis(6, 10, 3, torch.float64, device="cpu")
    row = torch.arange(30, dtype=torch.float64).reshape(10, 3)
    out = basis.write(store, 4, row, torch.tensor([True, False, True]))
    assert out is store
    np.testing.assert_array_equal(store[4, :, 0].numpy(), row[:, 0].numpy())
    assert (store[4, :, 1] == 7).all() and (store[:4] == 7).all()
    out = row_write.row_write_cuda(store, 5, row.float().double())
    assert out is store and torch.equal(store[5], row)
    assert row_write.row_write_cuda.launches == before
