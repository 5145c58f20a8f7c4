"""Sparse direct factorizations (``factorization/direct.py``) and the
direct solver (``solver/direct.py``): the port against ginkgo_tpu on the
same matrices, in f64 and complex128 on the CPU.  Factors must have the
reference's pattern and its values to 1e-12, on the native and on the
Python path; solves must agree to 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu import native as jnative
from ginkgo_tpu.factorization.direct import Cholesky as JCholesky
from ginkgo_tpu.factorization.direct import Lu as JLu
from ginkgo_tpu.solver.direct import Direct as JDirect
from ginkgo_tpu_torch import native
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.factorization import Cholesky, Lu
from ginkgo_tpu_torch.solver import Direct
from ginkgo_tpu_torch.utils import generators as tgen

CPU = torch.device("cpu")


def _spd(n, seed, cpx=False):
    d = tgen.make_spd(tgen.generate_random_matrix(
        n, n, nonzeros_per_row=(2, 5), seed=seed), shift=1.0)
    if cpx:
        # Hermitian positive definite: i (U - Uᵀ) added to the SPD matrix
        up = d.row_idx < d.col_idx
        lo = d.row_idx > d.col_idx
        v = d.values.astype(np.complex128)
        v[up] += 0.1j
        v[lo] -= 0.1j
        d = gtt.MatrixData(d.shape, d.row_idx, d.col_idx, v)
    return d


CASES = {
    "spd": lambda: _spd(40, 1),
    "hpd-c128": lambda: _spd(40, 2, cpx=True),
    "stencil": lambda: tgen.stencil_2d(9, points=9),
    "fem": lambda: build_matrix_data({"fem": 400, "offscale": 0.3}),
}


def _j(d):
    return gt.MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


def _same_factor(got, want, rtol=1e-12):
    g, w = got.to_matrix_data(), want.to_matrix_data()
    assert np.array_equal(g.row_idx, w.row_idx)
    assert np.array_equal(g.col_idx, w.col_idx)
    np.testing.assert_allclose(g.values, w.values, rtol=rtol,
                               atol=rtol * np.abs(w.values).max())


def _factor_both(fact, jfact, d):
    F = fact().generate(gtt.Csr.from_data(d, device="cpu"))
    Fj = jfact().generate(gt.Csr.from_data(_j(d)))
    return F, Fj


# Cholesky on the Hermitian cases only (the FEM matrix is not symmetric)
FACTOR_CASES = [("lu", case) for case in CASES] + [
    ("cholesky", case) for case in CASES if case != "fem"]


@pytest.mark.parametrize("native_path", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("kind,case", FACTOR_CASES,
                         ids=[f"{k}-{c}" for k, c in FACTOR_CASES])
def test_factors_match_jax(kind, case, native_path, monkeypatch):
    d = CASES[case]()
    if not native_path:
        monkeypatch.setattr(native, "lib", lambda: None)
        monkeypatch.setattr(jnative, "lib", lambda: None)
    fact, jfact = {"lu": (Lu, JLu), "cholesky": (Cholesky, JCholesky)}[kind]
    F, Fj = _factor_both(fact, jfact, d)
    assert F.symmetric == Fj.symmetric == (kind == "cholesky")
    assert F.l_factor.strategy == F.u_factor.strategy == "classical"
    assert F.l_factor.device == CPU
    _same_factor(F.l_factor, Fj.l_factor)
    _same_factor(F.u_factor, Fj.u_factor)
    dense = d.to_dense()
    LU = F.l_factor.to_dense().numpy() @ F.u_factor.to_dense().numpy()
    np.testing.assert_allclose(LU, dense, rtol=1e-10,
                               atol=1e-12 * np.abs(dense).max())


def test_native_and_python_paths_agree(monkeypatch):
    d = _spd(60, 5)
    A = gtt.Csr.from_data(d, device="cpu")
    nat = Lu().generate(A), Cholesky().generate(A)
    monkeypatch.setattr(native, "lib", lambda: None)
    py = Lu().generate(A), Cholesky().generate(A)
    for a, b in zip(nat, py):
        _same_factor(a.l_factor, b.l_factor)
        _same_factor(a.u_factor, b.u_factor)


@pytest.mark.parametrize("kind", ["lu", "cholesky"])
@pytest.mark.parametrize("case", ["spd", "hpd-c128", "stencil"])
def test_direct_solve_matches_jax(kind, case):
    d = CASES[case]()
    n = d.shape[0]
    x_true = np.random.default_rng(4).standard_normal((n, 2)).astype(
        d.values.dtype)
    b = d.to_dense() @ x_true
    fact, jfact = {"lu": (Lu, JLu), "cholesky": (Cholesky, JCholesky)}[kind]
    op = Direct(factorization=fact()).generate(
        gtt.Csr.from_data(d, device="cpu"))
    jop = JDirect(factorization=jfact()).generate(gt.Csr.from_data(_j(d)))
    x = op.solve(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, np.asarray(jop.apply(jnp.asarray(b))),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(x, x_true, rtol=1e-10, atol=1e-10)
    assert op.l_solver.algorithm == jop.l_solver.algorithm
    assert op.u_solver.algorithm == jop.u_solver.algorithm


def test_direct_defaults_to_lu_and_takes_a_factorization():
    d = CASES["fem"]()
    A = gtt.Csr.from_data(d, device="cpu")
    b = torch.ones(d.shape[0], dtype=torch.float64)
    x1 = Direct().generate(A).apply(b)
    x2 = Direct(factorization=Lu().generate(A)).generate(A).apply(b)
    np.testing.assert_array_equal(x1.numpy(), x2.numpy())
    r = d.to_dense() @ x1.numpy() - 1.0
    assert np.abs(r).max() < 1e-10
