"""Block Jacobi and its batched Gauss-Jordan/LU inverse
(``preconditioner/jacobi.py``, ``ops/gauss_jordan.py``): the port against
ginkgo_tpu on the same inputs, in f64 on the CPU (f32 and complex where
stated).

Inverses and applies agree to 1e-12 relative in f64 (1e-5 in f32): LU and
Gauss-Jordan sum in another order than the JAX package's, nothing else
differs.  Preconditioned CG takes the same iterations as the JAX package
on the block cases of ``tests/test_cg.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.ops import gauss_jordan as jgj
from ginkgo_tpu.preconditioner import jacobi as jjac
from ginkgo_tpu.solver import cg as jcg
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu.utils.generators import (generate_random_matrix, make_spd)
from ginkgo_tpu_torch.ops import gauss_jordan as tgj
from ginkgo_tpu_torch.preconditioner import Jacobi
from ginkgo_tpu_torch.preconditioner import jacobi as tjac
from ginkgo_tpu_torch.solver import Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import stencil_3d

TOL = {np.float64: 1e-12, np.float32: 1e-5, np.complex128: 1e-12,
       np.complex64: 1e-5}


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _blocks(dtype, nb=24, bs=5, seed=0):
    g = np.random.default_rng(seed)
    B = g.standard_normal((nb, bs, bs)) + 2 * np.eye(bs)
    if np.dtype(dtype).kind == "c":
        B = B + 1j * g.standard_normal(B.shape)
    return B.astype(dtype)


# -- gauss_jordan ------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(TOL),
                         ids=lambda d: d.__name__)
def test_gauss_jordan_inverse_matches_jax(dtype):
    B = _blocks(dtype)
    B[3] = 0                                  # every pivot zero
    B[4, :, 2] = 0                            # one zero column
    want = jax.vmap(jgj._gauss_jordan_inverse_single)(jnp.asarray(B))
    got = tgj._gauss_jordan_inverse_single(torch.from_numpy(B))
    _close(got, want, TOL[dtype])
    # the zero-pivot convention: an all-zero block inverts to I
    np.testing.assert_array_equal(got[3].numpy(), np.eye(B.shape[-1]))


@pytest.mark.parametrize("dtype", list(TOL),
                         ids=lambda d: d.__name__)
def test_batched_inverse_is_lu_and_matches_jax(dtype):
    B = _blocks(dtype, seed=1)
    got = tgj.batched_inverse(torch.from_numpy(B))
    _close(got, jgj.batched_inverse(jnp.asarray(B)), TOL[dtype])
    lu = torch.linalg.solve(torch.from_numpy(B),
                            torch.eye(B.shape[-1], dtype=got.dtype))
    assert torch.equal(got, lu)


def test_reduced_floats_take_gauss_jordan():
    B = torch.from_numpy(_blocks(np.float32, seed=2)).to(torch.bfloat16)
    got = tgj.batched_inverse(B)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tgj._gauss_jordan_inverse_single(B))
    want = np.linalg.inv(B.double().numpy())
    assert np.abs(got.double().numpy() - want).max() \
        <= 0.1 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=lambda d: d.__name__)
def test_batched_and_dense_solve_match_jax(dtype):
    B = _blocks(dtype, seed=3)
    g = np.random.default_rng(4)
    vec = g.standard_normal(B.shape[:2]).astype(dtype)
    mat = g.standard_normal(B.shape[:2] + (3,)).astype(dtype)
    for rhs in (vec, mat):
        _close(tgj.batched_solve(torch.from_numpy(B), torch.from_numpy(rhs)),
               jgj.batched_solve(jnp.asarray(B), jnp.asarray(rhs)), 1e-12)
        _close(tgj.dense_solve(torch.from_numpy(B[0]),
                               torch.from_numpy(rhs[0])),
               jgj.dense_solve(jnp.asarray(B[0]), jnp.asarray(rhs[0])),
               1e-12)
    half = torch.from_numpy(B.real.astype(np.float32)).to(torch.float16)
    x = tgj.batched_solve(half, torch.from_numpy(vec.real).to(torch.float16))
    assert x.dtype == torch.float16 and bool(torch.isfinite(x).all())


# -- block Jacobi ------------------------------------------------------------
def _from_dense(dense):
    r, c = np.nonzero(dense)
    return gtt.MatrixData(dense.shape, r, c, dense[r, c])


def _both(d):
    """The port's Csr on the CPU and the JAX package's, of MatrixData d."""
    return (gtt.Csr.from_data(d, device="cpu"),
            gt.Csr.from_data(gt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                           d.values)))


def _spd(n, seed):
    d = make_spd(generate_random_matrix(n, n, nonzeros_per_row=(1, 6),
                                        seed=seed), shift=0.5)
    return gtt.MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


def _apply_both(M, Mj, n, seed=5, k=2):
    b = np.random.default_rng(seed).standard_normal((n, k))
    return M.apply(torch.from_numpy(b)), Mj.apply(jnp.asarray(b))


BLOCK_CASES = {
    # (matrix, factory keyword arguments)
    "stencil_bs8": (lambda: stencil_3d(5, points=27),
                    dict(max_block_size=8)),
    "spd30_bs4": (lambda: _spd(30, 4), dict(max_block_size=4)),
    "spd37_bs8_f32": (lambda: _spd(37, 6),
                      dict(max_block_size=8, storage_dtype=np.float32)),
    "stencil_auto": (lambda: stencil_3d(5, points=27),
                     dict(max_block_size=8, storage_optimization="auto")),
    "natural": (lambda: stencil_3d(5, points=7),
                dict(max_block_size=4, natural_blocks=True)),
    "pointers": (lambda: _spd(10, 8), dict(block_pointers=[0, 2, 7, 10])),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_jacobi_matches_jax(case):
    make, kw = BLOCK_CASES[case]
    A, Aj = _both(make())
    M = Jacobi(**kw).generate(A)
    Mj = jjac.Jacobi(**kw).generate(Aj)
    assert type(M).__name__ == type(Mj).__name__
    for name in ("inv_blocks", "inv_full", "inv_reduced", "rows_pad"):
        if hasattr(Mj, name):
            got, want = getattr(M, name), np.asarray(getattr(Mj, name))
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
            _close(got.float() if got.dtype == torch.bfloat16 else got,
                   want.astype(np.float32) if str(want.dtype) == "bfloat16"
                   else want, 1e-12)
    got, want = _apply_both(M, Mj, A.shape[0])
    tol = 1e-5 if kw.get("storage_dtype") == np.float32 else 1e-12
    _close(got, want, tol)


def test_adaptive_storage_splits_by_condition():
    """``tests/test_cg.py::test_adaptive_perblock_precision_jacobi``'s
    matrix: two well-conditioned blocks stored in bf16, two ill-conditioned
    ones in f64."""
    rng = np.random.default_rng(9)
    n = 16
    dense = np.zeros((n, n))
    for s in range(0, 8, 4):
        dense[s:s + 4, s:s + 4] = np.eye(4) * rng.uniform(1, 2)
    for s in range(8, 16, 4):
        B = np.eye(4)
        B[0, 0] = 1e9
        dense[s:s + 4, s:s + 4] = B
    A, Aj = _both(_from_dense(dense))
    kw = dict(max_block_size=4, storage_optimization="auto", accuracy=1e-2)
    M = Jacobi(storage_dtype=torch.bfloat16, **kw).generate(A)
    Mj = jjac.Jacobi(storage_dtype=jnp.bfloat16, **kw).generate(Aj)
    assert M.inv_reduced.dtype == torch.bfloat16
    assert float(M.storage_fraction_reduced) == 0.5 == float(
        Mj.storage_fraction_reduced)
    got, want = _apply_both(M, Mj, n, k=1)
    _close(got, want, 1e-12)


def test_block_jacobi_zero_row_guard():
    """``tests/test_review_regressions.py``'s matrix: an all-zero row gets a
    unit diagonal in its block."""
    dense = np.diag([2.0, 0.0, 3.0, 4.0])
    A, Aj = _both(_from_dense(dense))
    M = Jacobi(max_block_size=2).generate(A)
    y = M.apply(torch.ones(4, dtype=torch.float64))
    np.testing.assert_allclose(y.numpy(), [0.5, 1.0, 1 / 3, 0.25])
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jjac.Jacobi(max_block_size=2).generate(Aj)
                              .apply(jnp.ones(4))))


def test_natural_blocks_match_jax():
    """``tests/test_cg.py::test_natural_block_jacobi``'s matrix (3x3 blocks,
    one off-block entry) and a 7-point stencil."""
    rng = np.random.default_rng(7)
    n = 12
    dense = np.zeros((n, n))
    for s in range(0, n, 3):
        dense[s:s + 3, s:s + 3] = rng.standard_normal((3, 3)) + 4 * np.eye(3)
    dense[0, 7] = 0.1
    for d in (_from_dense(dense), stencil_3d(4, points=7)):
        A, Aj = _both(d)
        for bs in (2, 3, 8):
            np.testing.assert_array_equal(
                tjac.find_natural_blocks(A, bs),
                jjac.find_natural_blocks(Aj, bs))
    A, _ = _both(_from_dense(dense))
    assert list(tjac.find_natural_blocks(A, 8)) == [0, 3, 6, 9, 12]


def test_block_pointers_must_cover_the_rows():
    A, _ = _both(_spd(10, 8))
    with pytest.raises(ValueError, match="cover"):
        Jacobi(block_pointers=[0, 5]).generate(A)


CG_CASES = {
    # tests/test_cg.py's block cases: _poisson(4) with block size 8, and
    # with f32 storage; a random SPD matrix with a partial last block
    "poisson4_bs8": (lambda: stencil_3d(4, points=27),
                     dict(max_block_size=8)),
    "poisson4_bs8_f32": (lambda: stencil_3d(4, points=27),
                         dict(max_block_size=8, storage_dtype=np.float32)),
    "poisson6_auto": (lambda: stencil_3d(6, points=27),
                      dict(max_block_size=8, storage_optimization="auto")),
    "spd37_bs4": (lambda: _spd(37, 6), dict(max_block_size=4)),
    "natural": (lambda: stencil_3d(6, points=7),
                dict(max_block_size=4, natural_blocks=True)),
}


@pytest.mark.parametrize("case", list(CG_CASES))
def test_block_jacobi_cg_iterations_match_jax(case):
    make, kw = CG_CASES[case]
    A, Aj = _both(make())
    n = A.shape[0]
    b = np.ones(n)
    res = Cg.solve(A, torch.from_numpy(b),
                   criteria=Iteration(2000) | ResidualNorm(1e-10),
                   preconditioner=Jacobi(**kw))
    resj = jcg.solve(Aj, jnp.asarray(b),
                     criteria=JIteration(2000) | JResidualNorm(1e-10),
                     preconditioner=jjac.Jacobi(**kw))
    assert bool(res.converged.all()) and bool(np.asarray(resj.converged).all())
    assert int(res.iterations[0]) == int(resj.iterations[0])
    _close(res.x, np.asarray(resj.x), 1e-9)
