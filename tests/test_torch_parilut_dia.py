"""The device DIA ParILUT/ParICT loop (``factorization/par_ilut_dia.py``):
the port against ginkgo_tpu's forced ``algorithm="dia"`` on the cases of
``tests/test_parilut_dia.py``, on the CPU.

Factors must have identical patterns and values within 1e-10 of max
|value| in f64 and complex128 (the JAX package sums each product as
one-hot matmuls, the port as one shifted multiply-add per lower offset:
the same terms plus exact zeros, in another order) and 1e-5 in f32;
preconditioned solves must take the same iterations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.factorization import par_ilut as jpi
from ginkgo_tpu.factorization import par_ilut_dia as jdia
from ginkgo_tpu.preconditioner.ilu import Ic as JIc
from ginkgo_tpu.preconditioner.ilu import Ilu as JIlu
from ginkgo_tpu.solver import Bicgstab as JBicgstab
from ginkgo_tpu.solver import Cg as JCg
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu_torch.base.matrix_data import MatrixData
from ginkgo_tpu_torch.factorization import ParIct, ParIlut
from ginkgo_tpu_torch.factorization import par_ilut_dia as tdia
from ginkgo_tpu_torch.preconditioner import Ic, Ilu
from ginkgo_tpu_torch.solver import Bicgstab, Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils import stagetimer
from ginkgo_tpu_torch.utils.generators import (generate_random_matrix,
                                               stencil_2d, stencil_3d)

F64_TOL = 1e-10
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """A DIA generate is thousands of small torch ops.  Under the suite's
    parallel workers their intra-op thread pools oversubscribe the cores
    (a generate that takes 2 s alone took minutes), so each test here runs
    torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(d):
    return (gtt.Csr.from_data(d, device="cpu"),
            gt.Csr.from_data(gt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                           d.values)))


def _assert_factor_equal(port_op, jax_op, tol):
    a, b = port_op.to_matrix_data(), jax_op.to_matrix_data()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.row_idx, b.row_idx)
    np.testing.assert_array_equal(a.col_idx, b.col_idx)
    bv = np.asarray(b.values)
    assert a.values.dtype == bv.dtype
    np.testing.assert_allclose(a.values, bv, rtol=tol,
                               atol=tol * np.abs(bv).max())


def _assert_same_factors(F, Fj, tol=F64_TOL):
    assert F.route == "dia"
    assert F.symmetric == Fj.symmetric
    _assert_factor_equal(F.l_factor, Fj.l_factor, tol)
    _assert_factor_equal(F.u_factor, Fj.u_factor, tol)


def _complex_stencil():
    """``test_dia_complex_values``' Helmholtz-like shifted stencil."""
    d = stencil_3d(6, points=7).canonical()
    vals = d.values.astype(np.complex128) * (1.0 + 0.3j)
    dg = d.row_idx == d.col_idx
    vals[dg] = np.abs(d.values[dg]) * (1.2 + 0.1j)
    return MatrixData(d.shape, d.row_idx, d.col_idx, vals)


def _f32(d):
    d = d.canonical()
    return MatrixData(d.shape, d.row_idx, d.col_idx,
                      d.values.astype(np.float32))


CASES = {
    # (matrix, iterations, fill_in_limit, tolerance)
    "stencil27_nx8": (lambda: stencil_3d(8, points=27), 4, 2.0, F64_TOL),
    "stencil27_nx5": (lambda: stencil_3d(5, points=27), 3, 2.0, F64_TOL),
    "stencil9_2d_nx24": (lambda: stencil_2d(24, points=9), 3, 1.5, F64_TOL),
    "complex128": (_complex_stencil, 3, 2.0, F64_TOL),
    "stencil27_nx8_f32": (lambda: _f32(stencil_3d(8, points=27)), 4, 2.0,
                          F32_TOL),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["ilut", "ict"])
def test_dia_factors_match_jax(kind, case):
    make, iters, fill, tol = CASES[case]
    A, Aj = _both(make())
    P, JP = (ParIlut, jpi.ParIlut) if kind == "ilut" else (ParIct,
                                                           jpi.ParIct)
    F = P(iterations=iters, fill_in_limit=fill, algorithm="dia").generate(A)
    Fj = JP(iterations=iters, fill_in_limit=fill,
            algorithm="dia").generate(Aj)
    _assert_same_factors(F, Fj, tol)


def test_dia_respects_fill_limit():
    d = stencil_2d(24, points=9).canonical()
    F = ParIlut(iterations=3, fill_in_limit=1.5,
                algorithm="dia").generate(gtt.Csr.from_data(d, device="cpu"))
    assert F.l_factor.nnz + F.u_factor.nnz <= 1.5 * d.nnz + d.shape[0] + 2


def test_dia_ict_budget_and_mirror():
    d = stencil_3d(8, points=27).canonical()
    F = ParIct(iterations=4, fill_in_limit=2.0,
               algorithm="dia").generate(gtt.Csr.from_data(d, device="cpu"))
    low_budget = int(np.ceil(2.0 * (d.row_idx >= d.col_idx).sum()))
    assert F.l_factor.nnz <= low_budget + 2
    L, U = F.l_factor.to_matrix_data(), F.u_factor.to_matrix_data()
    np.testing.assert_array_equal(
        L.to_dense().conj().T, U.to_dense())


def _ones2(n):
    return np.stack([np.ones(n),
                     np.random.default_rng(0).standard_normal(n)], axis=1)


@pytest.mark.parametrize("kind", ["ilut", "ict"])
def test_dia_preconditioned_solves_match_jax(kind):
    """``test_dia_preconditions`` / ``test_dia_ict_preconditions_spd``: the
    7-point stencil, 3 iterations, solved to 1e-10 in the same iterations
    as the JAX package, and in fewer than without the preconditioner."""
    d = stencil_3d(8, points=7)
    A, Aj = _both(d)
    b = _ones2(A.shape[0])
    if kind == "ilut":
        M = Ilu(ParIlut(iterations=3, algorithm="dia"))
        Mj = JIlu(jpi.ParIlut(iterations=3, algorithm="dia"))
        S, JS = Bicgstab, JBicgstab
    else:
        M = Ic(ParIct(iterations=3, algorithm="dia"))
        Mj = JIc(jpi.ParIct(iterations=3, algorithm="dia"))
        S, JS = Cg, JCg
    res = S.solve(A, torch.from_numpy(b), preconditioner=M,
                  criteria=Iteration(400) | ResidualNorm(1e-10))
    resj = JS.solve(Aj, jnp.asarray(b), preconditioner=Mj,
                    criteria=JIteration(400) | JResidualNorm(1e-10))
    plain = S.solve(A, torch.from_numpy(b),
                    criteria=Iteration(400) | ResidualNorm(1e-10))
    assert bool(res.converged.all())
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(resj.iterations))
    assert int(res.iterations.max()) < int(plain.iterations.max())
    np.testing.assert_allclose(res.x.numpy(), np.asarray(resj.x), rtol=1e-8,
                               atol=1e-8 * float(np.abs(resj.x).max()))


def test_dia_unstructured_declines():
    """A scattered random pattern: the ILUT plan declines (None), and the
    forced ``dia`` on the CPU goes on to the host path, as the JAX
    package's does."""
    data = generate_random_matrix(60, 60, nonzeros_per_row=(2, 5), seed=9)
    dd = data.to_dense()
    dd += np.diag(np.abs(dd).sum(1) + 1)
    r, c = np.nonzero(dd)
    d = MatrixData(dd.shape, r, c, dd[r, c])
    assert tdia.generate_dia(d.canonical(), 2, 2.0, 1) is None
    A, Aj = _both(d)
    F = ParIlut(iterations=2, algorithm="dia").generate(A)
    Fj = jpi.ParIlut(iterations=2, algorithm="dia").generate(Aj)
    assert F.route == "general"
    _assert_factor_equal(F.l_factor, Fj.l_factor, F64_TOL)
    _assert_factor_equal(F.u_factor, Fj.u_factor, F64_TOL)


def test_dia_generate_is_pure():
    """``generate_dia`` leaves the canonical MatrixData it reads unchanged,
    and returns the same split arrays as the JAX package's."""
    d = stencil_3d(5, points=27).canonical()
    vals0, row0, col0 = d.values.copy(), d.row_idx.copy(), d.col_idx.copy()
    out = tdia.generate_dia(d, iterations=3, fill_in_limit=2.0, sweeps=1)
    outj = jdia.generate_dia(d, iterations=3, fill_in_limit=2.0, sweeps=1)
    np.testing.assert_array_equal(d.values, vals0)
    np.testing.assert_array_equal(d.row_idx, row0)
    np.testing.assert_array_equal(d.col_idx, col0)
    for a, b in zip(out, outj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=F64_TOL,
                                   atol=F64_TOL * np.abs(b).max())


def test_dia_stagetimer_splits_the_generate():
    d = stencil_3d(5, points=27).canonical()
    for fn in (lambda: tdia.generate_dia(d, 2, 2.0, 1),
               lambda: tdia.generate_dia_ict(d, 2, 2.0)):
        with stagetimer.collect() as st:
            fn()
        assert set(st.stages) == {"transfer", "device"}


def test_product_matches_a_dense_product():
    """``_product`` on random slabs (every slot active) against the dense
    (I+L) U restricted to the universe, and its mask against the dense
    product's pattern."""
    d = stencil_3d(4, points=7).canonical()
    plan = tdia.plan_dia(d)
    u, n_low = plan["universe"], plan["n_low"]
    n = d.shape[0]
    g = np.random.default_rng(3)
    V = g.standard_normal((u.size, n))
    rows = np.arange(n)
    valid = (rows[None, :] + u[:, None] >= 0) & (rows[None, :] + u[:, None]
                                                  < n)
    M = (valid & (g.random(V.shape) < 0.7)).astype(np.uint8)
    V = V * M
    dense = {}
    for p, o in enumerate(u):
        m = np.zeros((n, n))
        r = rows[M[p] == 1]
        m[r, r + o] = V[p, r]
        dense[p] = m
    Lf = sum(dense[p] for p in range(n_low)) + np.eye(n)
    Uf = sum(dense[p] for p in range(n_low, u.size))
    Pd = Lf @ Uf
    terms = tdia._ship_terms(tdia._terms(u[:n_low, None] + u[None, n_low:],
                                         u), u[:n_low], "cpu")
    pad = int(np.abs(u).max())
    C, Cm = tdia._product(torch.from_numpy(V), torch.from_numpy(M), terms,
                          n_low, pad, want_mask=True)
    Pm = (np.abs(Lf) > 0).astype(float) @ (np.abs(Uf) > 0).astype(float)
    for p, o in enumerate(u):
        r = rows[valid[p]]
        np.testing.assert_allclose(C[p, r].numpy(), Pd[r, r + o],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(Cm[p, r].numpy(), Pm[r, r + o] > 0)
