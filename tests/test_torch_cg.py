"""Jacobi-preconditioned CG in f64: the port against ginkgo_tpu on the same
operators and right-hand sides.  Per column, ``iterations``, ``converged``
and ``stagnated`` must be identical and x must agree to rtol 1e-10 (the
dot products are summed in another order, nothing else differs).

Each system runs twice on the port side: on the layout the port plans
itself (``Csr.from_data``) and on the JAX package's planned arrays carried
over by ``interop.csr_from_arrays``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.preconditioner.jacobi import Jacobi as JJacobi
from ginkgo_tpu.solver import Cg as JCg
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu.stop.criterion import Time as JTime
from ginkgo_tpu_torch.interop import csr_from_arrays
from ginkgo_tpu_torch.log import logger as tlog
from ginkgo_tpu_torch.preconditioner import Jacobi
from ginkgo_tpu_torch.solver import Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm, Time
from ginkgo_tpu_torch.utils import generators as tgen

SYSTEMS = {
    "stencil27": (lambda: tgen.stencil_3d(8, points=27), "banded"),
    "stencil7": (lambda: tgen.stencil_3d(10, 9, 8, points=7), "banded"),
    "permuted": (lambda: tgen.permute_locally(
        tgen.stencil_3d(16, 16, 8, points=27)), "packed"),
}
ARRAYS = ("row_ptr", "col_idx", "values", "row_idx", "diag_values",
          "tail_rows", "tail_cols", "tail_vals", "pell_vals", "pell_idx",
          "pell_qw", "pell_xbase")
STATIC = ("shape", "nnz", "strategy", "diag_offsets", "band_meta",
          "pell_meta")


def _rhs(n, seed=0):
    """Three columns that converge at different iterations: a smooth
    one, a rough one and a mixed one of another scale."""
    rng = np.random.default_rng(seed)
    smooth = np.ones(n)
    rough = rng.standard_normal(n)
    mixed = 1e3 * (np.sin(np.arange(n) / 7.0) + 0.1 * rng.standard_normal(n))
    return np.stack([smooth, rough, mixed], axis=1)


def _jax_solve(d, b, crit, scalar_l1=False):
    Aj = gt.Csr.from_data(gt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                        d.values))
    res = JCg.solve(Aj, jnp.asarray(b), criteria=crit,
                    preconditioner=JJacobi(scalar_l1=scalar_l1))
    return Aj, res


def _assert_same(rt, rj):
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.stagnated.numpy(),
                                  np.asarray(rj.stagnated))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10,
                               atol=1e-10 * float(np.abs(rj.x).max()))


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_jacobi_cg_matches_jax(name):
    make, strategy = SYSTEMS[name]
    d = make()
    b = _rhs(d.shape[0])
    Aj, rj = _jax_solve(d, b, JIteration(400) | JResidualNorm(1e-10))
    assert Aj.strategy == strategy
    assert len(set(np.asarray(rj.iterations).tolist())) > 1
    crit = Iteration(400) | ResidualNorm(1e-10)

    At = gtt.Csr.from_data(d, device="cpu")
    assert At.strategy == strategy
    rt = Cg.solve(At, torch.from_numpy(b), criteria=crit,
                  preconditioner=Jacobi())
    _assert_same(rt, rj)

    arrays = {k: None if getattr(Aj, k) is None else np.asarray(getattr(Aj, k))
              for k in ARRAYS}
    Ai = csr_from_arrays(arrays, {k: getattr(Aj, k) for k in STATIC},
                         device="cpu")
    assert Ai.strategy == strategy
    ri = Cg.solve(Ai, torch.from_numpy(b), criteria=crit,
                  preconditioner=Jacobi())
    _assert_same(ri, rj)


def test_iteration_cap_scalar_l1_and_single_column():
    """A cap that stops every column unconverged, the L1-augmented scalar
    Jacobi, and the single-column shortcut of the loop."""
    d = tgen.stencil_3d(8, points=27)
    b = _rhs(d.shape[0], seed=1)
    _, rj = _jax_solve(d, b, JIteration(7) | JResidualNorm(1e-12),
                       scalar_l1=True)
    At = gtt.Csr.from_data(d, device="cpu")
    rt = Cg.solve(At, torch.from_numpy(b),
                  criteria=Iteration(7) | ResidualNorm(1e-12),
                  preconditioner=Jacobi(scalar_l1=True))
    _assert_same(rt, rj)
    assert not rt.converged.any() and (rt.iterations == 7).all()

    _, rj1 = _jax_solve(d, b[:, 1], JIteration(300) | JResidualNorm(1e-9))
    rt1 = Cg.solve(At, torch.from_numpy(b[:, 1].copy()),
                   criteria=Iteration(300) | ResidualNorm(1e-9),
                   preconditioner=Jacobi())
    assert rt1.x.shape == (d.shape[0],)
    _assert_same(rt1, rj1)


def test_audit_marks_stagnation_like_jax():
    """A tolerance below what f32 can reach: the recurrent residual claims
    convergence, the true-residual audit contradicts it, and after
    ``verify_retries`` restarts the column reports ``stagnated``."""
    d = tgen.stencil_3d(12, points=27, dtype=np.float32)
    b = np.ones((d.shape[0], 1), np.float32)
    crit_j = JIteration(500) | JResidualNorm(1e-7)
    Aj = gt.Csr.from_data(gt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                        d.values))
    rj = JCg.solve(Aj, jnp.asarray(b), criteria=crit_j,
                   preconditioner=JJacobi())
    At = gtt.Csr.from_data(d, device="cpu")
    rt = Cg.solve(At, torch.from_numpy(b),
                  criteria=Iteration(500) | ResidualNorm(1e-7),
                  preconditioner=Jacobi())
    assert bool(np.asarray(rj.stagnated).all())
    np.testing.assert_array_equal(rt.stagnated.numpy(),
                                  np.asarray(rj.stagnated))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))


def test_factory_surface_and_block_jacobi_raises():
    d = tgen.stencil_3d(6, points=7)
    A = gtt.Csr.from_data(d, device="cpu")
    solver = Cg.build(criteria=Iteration(200) | ResidualNorm(1e-10),
                      preconditioner=Jacobi()).generate(A)
    x = solver.apply(torch.ones(A.shape[0], dtype=torch.float64))
    r = torch.ones(A.shape[0], dtype=torch.float64) - A.apply(x)
    assert float(r.norm()) < 1e-8 * A.shape[0] ** 0.5
    # block Jacobi generates (tests/test_torch_block_jacobi.py holds it
    # against the JAX package) and preconditions the same solver
    block = Cg.build(criteria=Iteration(200) | ResidualNorm(1e-10),
                     preconditioner=Jacobi(max_block_size=4)).generate(A)
    x = block.apply(torch.ones(A.shape[0], dtype=torch.float64))
    r = torch.ones(A.shape[0], dtype=torch.float64) - A.apply(x)
    assert float(r.norm()) < 1e-8 * A.shape[0] ** 0.5
    # trace=True: the residual norm of every trip, shaped as the
    # reference's fixed-length scan (cap + 1, k), with equal iterations
    b = _rhs(A.shape[0], seed=3)
    Aj = gt.Csr.from_data(gt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                        d.values))
    rj = JCg.solve(Aj, jnp.asarray(b), criteria=JIteration(80)
                   | JResidualNorm(1e-10), preconditioner=JJacobi(),
                   trace=True)
    rt = Cg.solve(A, torch.from_numpy(b), criteria=Iteration(80)
                  | ResidualNorm(1e-10), preconditioner=Jacobi(), trace=True)
    hj = np.asarray(rj.resnorm_history)
    assert rt.resnorm_history.shape == hj.shape == (81, 3)
    np.testing.assert_allclose(rt.resnorm_history.numpy(), hj, rtol=1e-9,
                               atol=1e-12 * hj.max())
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    assert int(rt.iterations.max()) < 80


def test_time_criterion_runs_the_host_loop_like_jax():
    """A criterion that reads the clock runs the plain host loop (no
    audit, so no ``stagnated``) and fires one iteration event per trip."""
    d = tgen.stencil_3d(8, points=27)
    b = _rhs(d.shape[0], seed=2)
    _, rj = _jax_solve(d, b, JIteration(300) | JResidualNorm(1e-9)
                       | JTime(600.0))

    class Count(tlog.Logger):
        def __init__(self):
            super().__init__(events_mask=[tlog.ITERATION_COMPLETE])
            self.n = 0

        def on(self, event, **data):
            self.n += 1

    At = gtt.Csr.from_data(d, device="cpu")
    with tlog.capture(Count()) as counter:
        rt = Cg.solve(At, torch.from_numpy(b),
                      criteria=Iteration(300) | ResidualNorm(1e-9)
                      | Time(600.0), preconditioner=Jacobi())
    assert rj.stagnated is None and rt.stagnated is None
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    assert counter.n == int(rt.iterations.max())
