"""The twelve Krylov solvers of the port against ginkgo_tpu, on the real
f64 and complex128 systems of ``tests/test_complex_sweep.py`` (N = 24;
Hermitian positive definite for CG, FCG, pipelined CG, MINRES, Chebyshev
and Richardson, general for the rest), with two right-hand sides that stop
at different iterations.

Per column, ``iterations``, ``converged`` and ``stagnated`` must be equal
and x must agree to 1e-10 (relative to max |x|): the port sums in another
order (torch's reductions and matmuls against XLA's), nothing else
differs.  Each system is built once per module on each side.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu.solver as jsolver
import ginkgo_tpu_torch as gtt
import ginkgo_tpu_torch.solver as tsolver
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu.utils.generators import generate_random_matrix, make_spd
from ginkgo_tpu_torch.base.dtypes import complex_dtype, is_complex
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import stencil_3d

N = 24
MAX_ITERS = 800
TOL = 1e-10


def _systems():
    """``test_complex_sweep._systems`` with the real counterparts: the
    real SPD matrix and the real part of the general one."""
    data = make_spd(generate_random_matrix(
        N, N, nonzeros_per_row=(2, 5), seed=0), shift=2.0)
    skew = generate_random_matrix(N, N, nonzeros_per_row=(1, 3),
                                  seed=2).to_dense() * 0.1
    hpd = data.to_dense().astype(complex) + 1j * (skew - skew.T)
    rng = np.random.default_rng(0)
    gen = hpd + 0.3 * (rng.standard_normal((N, N)) * (np.abs(hpd) > 0))
    x = rng.standard_normal((N, 2)) + 1j * rng.standard_normal((N, 2))
    x[:, 1] *= 1e-3 * (1 + np.arange(N))
    return {("hpd", "complex128"): hpd, ("gen", "complex128"): gen,
            ("hpd", "float64"): data.to_dense(),
            ("gen", "float64"): np.real(gen)}, x


MATRICES, X_TRUE = _systems()


@functools.lru_cache(maxsize=None)
def _system(kind, dtype):
    """(JAX Csr, port Csr on the CPU, b) of one system, built once."""
    dense = MATRICES[(kind, dtype)]
    x = X_TRUE if dtype == "complex128" else np.real(X_TRUE)
    b = dense @ x
    Aj = gt.Csr.from_dense(dense)
    At = gtt.Csr.from_data(gtt.MatrixData.from_dense(dense), device="cpu")
    assert At.strategy == Aj.strategy
    return Aj, At, b


def _eig_range(kind, dtype):
    ev = np.linalg.eigvalsh(MATRICES[(kind, dtype)])
    return float(ev[0]), float(ev[-1])


# name -> (solver, system, keyword arguments for both packages); a value
# given as a function of the dtype is computed per system, and "gmres15"
# is each package's own Gmres(15 iterations) inner solver
CASES = {
    "cg": ("Cg", "hpd", {}),
    "fcg": ("Fcg", "hpd", {}),
    "pipe_cg": ("PipeCg", "hpd", {}),
    "minres": ("Minres", "hpd", {}),
    "chebyshev": ("Chebyshev", "hpd",
                  {"foci": lambda dtype: _eig_range("hpd", dtype)}),
    "richardson": ("Ir", "hpd", {
        "relaxation_factor": lambda dtype: 1 / _eig_range("hpd", dtype)[1]}),
    "bicg": ("Bicg", "gen", {}),
    "bicgstab": ("Bicgstab", "gen", {}),
    "cgs": ("Cgs", "gen", {}),
    "gmres": ("Gmres", "gen", {}),
    "gcr": ("Gcr", "gen", {}),
    "gcr_restarted": ("Gcr", "gen", {"krylov_dim": 4}),
    "idr": ("Idr", "gen", {}),
    "idr_seed": ("Idr", "gen", {"subspace_dim": 3, "seed": 7}),
    "ir_gmres": ("Ir", "gen", {"solver": "gmres15"}),
}


def _kwargs(kw, dtype, pkg):
    out = {}
    for key, val in kw.items():
        if val == "gmres15":
            out[key] = (jsolver.Gmres.build(criteria=JIteration(15))
                        if pkg == "jax" else
                        tsolver.Gmres.build(criteria=Iteration(15)))
        elif callable(val):
            out[key] = val(dtype)
        else:
            out[key] = val
    return out


def _solve_both(case, dtype):
    name, kind, kw = CASES[case]
    Aj, At, b = _system(kind, dtype)
    rj = getattr(jsolver, name).solve(
        Aj, jnp.asarray(b), criteria=JIteration(MAX_ITERS)
        | JResidualNorm(TOL), **_kwargs(kw, dtype, "jax"))
    rt = getattr(tsolver, name).solve(
        At, torch.from_numpy(b), criteria=Iteration(MAX_ITERS)
        | ResidualNorm(TOL), **_kwargs(kw, dtype, "port"))
    return rj, rt


def _assert_same(rt, rj):
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    assert (rt.stagnated is None) == (rj.stagnated is None)
    if rt.stagnated is not None:
        np.testing.assert_array_equal(rt.stagnated.numpy(),
                                      np.asarray(rj.stagnated))
    xj = np.asarray(rj.x)
    xt = rt.x.numpy()
    assert xt.dtype == xj.dtype
    err = np.abs(xt - xj).max() / np.abs(xj).max()
    assert err <= 1e-10, err


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_matches_reference(case, dtype):
    rj, rt = _solve_both(case, dtype)
    _assert_same(rt, rj)
    assert bool(rt.converged.all()), rt.iterations
    if case == "gcr_restarted":
        assert int(rt.iterations.max()) > 4       # it did restart
    # the solve is right, not only alike: x against the true solution
    x = X_TRUE if dtype == "complex128" else np.real(X_TRUE)
    np.testing.assert_allclose(rt.x.numpy(), x, rtol=1e-6, atol=1e-6)


def test_solver_exports():
    """Every solver of the JAX package's Krylov family is exported under
    its name, with the SolverAPI surface."""
    for name in ("Cg", "Fcg", "PipeCg", "Bicg", "Bicgstab", "Cgs", "Minres",
                 "Gmres", "CbGmres", "Gcr", "Idr", "Ir", "Richardson",
                 "Chebyshev"):
        api = getattr(tsolver, name)
        assert callable(api.solve) and callable(api.build), name
        assert api.name == getattr(jsolver, name).name, name


def test_factory_generate_solves():
    """``build(...).generate(A).apply(b)`` is ``solve(A, b).x``."""
    _, At, b = _system("gen", "complex128")
    bt = torch.from_numpy(b)
    crit = Iteration(MAX_ITERS) | ResidualNorm(TOL)
    op = tsolver.Idr.build(criteria=crit, subspace_dim=3).generate(At)
    x = tsolver.Idr.solve(At, bt, criteria=crit, subspace_dim=3).x
    torch.testing.assert_close(op.apply(bt), x, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16",
                                   "complex64", "complex128"])
def test_complex_dtype_helpers(dtype):
    from ginkgo_tpu.base import dtypes as jd
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    assert is_complex(tdt) == jd.is_complex(jdt)
    assert str(complex_dtype(tdt)).removeprefix("torch.") == \
        jnp.dtype(jd.complex_dtype(jdt)).name


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("kind", ["banded", "classical"])
def test_transpose_matches_dense(kind, conj):
    """``Csr.transpose``/``conj_transpose`` against the dense transpose,
    and the banded layout kept for a banded matrix."""
    rng = np.random.default_rng(3)
    if kind == "banded":
        data = stencil_3d(6, points=7)
        vals = data.values * (1 + 0.3j) + 0.1j * rng.standard_normal(
            data.nnz)
        data = gtt.MatrixData(data.shape, data.row_idx, data.col_idx, vals)
    else:
        data = gtt.MatrixData.from_dense(MATRICES[("gen", "complex128")])
    A = gtt.Csr.from_data(data, device="cpu")
    assert A.strategy == kind
    T = A.conj_transpose() if conj else A.transpose()
    assert T.strategy == kind
    dense = data.to_dense()
    want = dense.conj().T if conj else dense.T
    x = rng.standard_normal((A.shape[0], 2)) + 1j
    np.testing.assert_allclose(T.apply(torch.from_numpy(x)).numpy(),
                               want @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(T.to_matrix_data().to_dense(), want,
                               rtol=0, atol=0)
