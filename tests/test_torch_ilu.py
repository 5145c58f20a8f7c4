"""Incomplete factorizations, ILU/IC preconditioning and BiCGSTAB: the port
against ginkgo_tpu on the same inputs, in f64 on the CPU.

Factors must match to rtol 1e-12 (exact ILU(0)/IC(0), the same C++
source) and 1e-10 (ParILU/ParIC sweeps, sums in another order).  Solves
must report identical per-column ``iterations``, ``converged`` and
``stagnated`` and agree on x to rtol 1e-10; each runs on the port's own
factors and on the JAX package's factors carried over by
``interop.factorization_from_arrays``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.benchmark.runner import build_matrix_data as jbuild
from ginkgo_tpu.factorization import par_ilu as jpar
from ginkgo_tpu.preconditioner import Ic as JIc
from ginkgo_tpu.preconditioner import Ilu as JIlu
from ginkgo_tpu.solver import Bicgstab as JBicgstab
from ginkgo_tpu.solver import Cg as JCg
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu_torch import native
from ginkgo_tpu_torch.base.composition import Composition
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.factorization import Ic0, Ilu0, ParIc, ParIlu
from ginkgo_tpu_torch.interop import factorization_from_arrays
from ginkgo_tpu_torch.preconditioner import Ic, Ilu
from ginkgo_tpu_torch.solver import Bicgstab, Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils import generators as tgen

CSR_ARRAYS = ("row_ptr", "col_idx", "values", "row_idx", "diag_values",
              "tail_rows", "tail_cols", "tail_vals", "pell_vals", "pell_idx",
              "pell_qw", "pell_xbase")
CSR_STATIC = ("shape", "nnz", "strategy", "diag_offsets", "band_meta",
              "pell_meta")


def fem(n=2048):
    return build_matrix_data({"fem": n, "offscale": 1.2})


def stencil():
    return tgen.stencil_3d(8, points=27)


def stencil7():
    return tgen.stencil_3d(10, points=7)


def _both(d):
    """(port Csr on the CPU, JAX Csr) of the same f64 data."""
    return (gtt.Csr.from_data(d, device="cpu"),
            gt.Csr.from_data(gt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                           d.values)))


def _assert_factor_equal(port_op, jax_op, rtol):
    a, b = port_op.to_matrix_data(), jax_op.to_matrix_data()
    assert a.shape == b.shape
    assert np.array_equal(a.row_idx, b.row_idx)
    assert np.array_equal(a.col_idx, b.col_idx)
    np.testing.assert_allclose(a.values, b.values, rtol=rtol,
                               atol=rtol * np.abs(b.values).max())


def test_generator_matches_jax():
    for case in ({"fem": 2048, "offscale": 1.2},
                 {"fem": 1000, "sym": True},
                 {"stencil": "7pt", "size": 6}):
        d, dj = build_matrix_data(case), jbuild(case)
        assert d.shape == dj.shape
        for name in ("row_idx", "col_idx", "values"):
            assert np.array_equal(getattr(d, name), getattr(dj, name))
    with pytest.raises(NotImplementedError, match="mtx_io"):
        build_matrix_data({"filename": "a.mtx"})
    with pytest.raises(NotImplementedError, match="reorder"):
        build_matrix_data({"fem": 100, "rcm": True})


FACTORIZATIONS = [
    ("ilu0-fem", lambda: Ilu0(), lambda: jpar.Ilu0(), fem, 1e-12),
    ("ilu0-stencil", lambda: Ilu0(), lambda: jpar.Ilu0(), stencil, 1e-12),
    ("parilu-fem", lambda: ParIlu(iterations=5),
     lambda: jpar.ParIlu(iterations=5), fem, 1e-10),
    ("parilu-stencil", lambda: ParIlu(iterations=3),
     lambda: jpar.ParIlu(iterations=3), stencil, 1e-10),
    ("ic0-stencil", lambda: Ic0(), lambda: jpar.Ic0(), stencil, 1e-12),
    ("paric-stencil", lambda: ParIc(iterations=4),
     lambda: jpar.ParIc(iterations=4), stencil, 1e-10),
]


@pytest.mark.parametrize("name,make,jmake,data,rtol", FACTORIZATIONS,
                         ids=[f[0] for f in FACTORIZATIONS])
def test_factorization_matches_jax(name, make, jmake, data, rtol):
    A, Aj = _both(data())
    F, Fj = make().generate(A), jmake().generate(Aj)
    assert F.symmetric == Fj.symmetric
    _assert_factor_equal(F.l_factor, Fj.l_factor, rtol)
    _assert_factor_equal(F.u_factor, Fj.u_factor, rtol)
    assert F.l_factor.device.type == "cpu"
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (A.shape[0], 2)))
    np.testing.assert_allclose(F.to_composition()._apply(b).numpy(),
                               F._apply(b).numpy(), rtol=1e-14)


def test_native_builds_in_port_and_matches_python_fallback(monkeypatch):
    lib = native.lib()
    assert lib is not None
    assert "ginkgo_tpu_torch" in native._LIBPATH
    assert native._LIBPATH.startswith(native._HERE)
    d = tgen.generate_random_matrix(200, 200, nonzeros_per_row=(2, 6),
                                    seed=3, ensure_diag=True)
    A = gtt.Csr.from_data(d, device="cpu")
    F_native = Ilu0().generate(A)
    monkeypatch.setattr(native, "lib", lambda: None)
    F_python = Ilu0().generate(A)
    _assert_factor_equal(F_native.l_factor, F_python.l_factor, 1e-12)
    _assert_factor_equal(F_native.u_factor, F_python.u_factor, 1e-12)
    # ParILU's pair lists: native against the Python enumeration
    from ginkgo_tpu_torch.factorization.par_ilu import (_pair_lists,
                                                        _split_pattern)
    _, (lr, lc), (ur, uc) = _split_pattern(d)
    py = _pair_lists(lr, lc, ur, uc, 200)
    monkeypatch.undo()
    nat = _pair_lists(lr, lc, ur, uc, 200)
    key = lambda t: np.lexsort((t[1], t[0], t[2]))  # noqa: E731
    for a, b in zip((x[key(py)] for x in py), (x[key(nat)] for x in nat)):
        assert np.array_equal(a, b)


def test_sum_duplicates_native_matches_numpy(monkeypatch):
    rng = np.random.default_rng(8)
    n, nnz = 3000, 1 << 17
    d = gtt.MatrixData((n, n), rng.integers(0, n, nnz),
                       rng.integers(0, n, nnz), rng.standard_normal(nnz))
    fast = d.sum_duplicates()
    monkeypatch.setattr(native, "lib", lambda: None)
    slow = d.sum_duplicates()
    assert fast.nnz == slow.nnz < nnz
    assert np.array_equal(fast.row_idx, slow.row_idx)
    assert np.array_equal(fast.col_idx, slow.col_idx)
    np.testing.assert_allclose(fast.values, slow.values, rtol=1e-12,
                               atol=1e-12)


def _rhs(n, seed=0):
    """Three columns that converge at different iterations: a smooth one,
    a rough one and a unit spike.  The spike sits at row 100: at row 0
    the fem system's BiCGSTAB nears a breakdown and amplifies rounding,
    so the iteration count there depends on the order of sums."""
    rng = np.random.default_rng(seed)
    spike = np.zeros(n)
    spike[100] = 1.0
    return np.stack([np.ones(n), rng.standard_normal(n), spike], axis=1)


def _carry(Fj):
    """A JAX factorization's factors as the port's (via interop)."""
    def one(op):
        arrays = {k: None if getattr(op, k, None) is None
                  else np.asarray(getattr(op, k)) for k in CSR_ARRAYS}
        return arrays, {k: getattr(op, k) for k in CSR_STATIC}
    return factorization_from_arrays(one(Fj.l_factor), one(Fj.u_factor),
                                     symmetric=Fj.symmetric, device="cpu")


def _assert_same(rt, rj):
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.stagnated.numpy(),
                                  np.asarray(rj.stagnated))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10,
                               atol=1e-10 * float(np.abs(rj.x).max()))


SOLVES = [
    # (label, data, port factory, jax factory, port precond, jax precond,
    #  port solver, jax solver)
    ("parilu-bicgstab-fem", fem, lambda: ParIlu(iterations=5),
     lambda: jpar.ParIlu(iterations=5), Ilu, JIlu, Bicgstab, JBicgstab),
    ("ilu0-bicgstab-fem", fem, Ilu0, jpar.Ilu0, Ilu, JIlu, Bicgstab,
     JBicgstab),
    ("ic0-cg-stencil", stencil7, Ic0, jpar.Ic0, Ic, JIc, Cg, JCg),
]


@pytest.mark.parametrize("carry", [False, True], ids=["own", "interop"])
@pytest.mark.parametrize("case", SOLVES, ids=[s[0] for s in SOLVES])
def test_preconditioned_solve_matches_jax(case, carry):
    label, data, fact, jfact, prec, jprec, solver, jsolver = case
    d = data()
    A, Aj = _both(d)
    b = _rhs(d.shape[0])
    Fj = jfact().generate(Aj)
    Mj = jprec(factorization=Fj).generate(Aj)
    rj = jsolver.solve(Aj, jnp.asarray(b),
                       criteria=JIteration(300) | JResidualNorm(1e-10),
                       preconditioner=Mj)
    assert len(set(np.asarray(rj.iterations).tolist())) > 1
    F = _carry(Fj) if carry else fact().generate(A)
    M = prec(factorization=F).generate(A)
    assert (M.l_solver.algorithm, M.u_solver.algorithm) == (
        Mj.l_solver.algorithm, Mj.u_solver.algorithm)
    rt = solver.solve(A, torch.from_numpy(b),
                      criteria=Iteration(300) | ResidualNorm(1e-10),
                      preconditioner=M)
    _assert_same(rt, rj)


def test_default_factorizations_and_factory_surface():
    """Ilu()/Ic() default to exact ILU(0)/IC(0); the fluent solver
    factory takes an ILU preconditioner factory."""
    d = fem(1024)
    A, Aj = _both(d)
    M, Mj = Ilu().generate(A), JIlu().generate(Aj)
    b = _rhs(1024)
    np.testing.assert_allclose(M.apply(torch.from_numpy(b)).numpy(),
                               np.asarray(Mj.apply(jnp.asarray(b))),
                               rtol=1e-10, atol=1e-10)
    solver = Bicgstab.build(criteria=Iteration(100) | ResidualNorm(1e-10),
                            preconditioner=Ilu()).generate(A)
    x = solver.apply(torch.from_numpy(b[:, 0].copy()))
    r = torch.from_numpy(b[:, 0].copy()) - A.apply(x)
    assert float(r.norm()) < 1e-8 * float(np.linalg.norm(b[:, 0]))
    S, _ = _both(stencil())
    Mc = Ic().generate(S)
    assert Mc.l_solver.algorithm == "exact"
    with pytest.raises(ValueError, match="non-conformant"):
        Composition(ops=(A, S))
