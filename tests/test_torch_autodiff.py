"""Implicit differentiation of solves (``autodiff.py``): the port against
ginkgo_tpu's ``jax.grad`` on the same numpy inputs and operator layouts,
on the CPU, in f64.

Each value buffer's gradient must equal the reference's to 1e-10 of its
largest entry — for complex values the conjugate of the reference's
(torch's convention is the conjugate of JAX's cotangent; the port's
gradients are those of ``torch.linalg.solve``, which the tests also hold
them to on the dense matrix)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.autodiff import make_differentiable_solve as jmake
from ginkgo_tpu.solver import cg as jcg
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu.utils.generators import (generate_random_matrix, make_spd,
                                         stencil_3d)
from ginkgo_tpu_torch.autodiff import make_differentiable_solve
from ginkgo_tpu_torch.base.matrix_data import MatrixData
from ginkgo_tpu_torch.interop import (INDEX_ARRAYS, SLAB_ARRAYS,
                                      STATIC_FIELDS, VALUE_ARRAYS,
                                      csr_from_arrays)
from ginkgo_tpu_torch.solver import bicgstab, cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import permute_locally

TOL = 1e-10
JCRIT = JIteration(2000) | JResidualNorm(1e-13)
CRIT = Iteration(2000) | ResidualNorm(1e-13)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def _port_csr(Aj):
    """The JAX Csr's arrays as the port's Csr: identical layouts."""
    names = INDEX_ARRAYS + VALUE_ARRAYS + tuple(SLAB_ARRAYS)
    arrays = {k: None if getattr(Aj, k) is None else np.asarray(getattr(Aj, k))
              for k in names}
    return csr_from_arrays(arrays, {k: getattr(Aj, k) for k in STATIC_FIELDS},
                           device="cpu")


def _spd(n=12, seed=0):
    return make_spd(generate_random_matrix(
        n, n, nonzeros_per_row=(2, 4), seed=seed), shift=1.0)


def _banded_with_tail():
    """A 7-point stencil, shifted, with 12 symmetric far-off pairs: the
    planner keeps the band and spills the pairs to the COO tail."""
    d = stencil_3d(8, points=7)
    n = d.shape[0]
    rng = np.random.default_rng(5)
    r = rng.choice(n // 2, 12, replace=False)
    c = r + n // 2
    v = np.full(12, 0.1)
    rows = np.concatenate([d.row_idx, r, c, np.arange(n)])
    cols = np.concatenate([d.col_idx, c, r, np.arange(n)])
    vals = np.concatenate([d.values, v, v, np.ones(n)])
    return gt.MatrixData(d.shape, rows, cols, vals).canonical()


def _jax_data(d):
    return gt.MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


SYSTEMS = {
    "classical": (lambda: _spd(14, seed=2), "classical"),
    "banded": (lambda: stencil_3d(6, points=27), "banded"),
    "banded_tail": (_banded_with_tail, "banded"),
    "packed": (lambda: _jax_data(permute_locally(
        stencil_3d(16, 8, 8, points=7))), "packed"),
}


def _loss_grads_port(solve, A, b, fields):
    for name in fields:
        getattr(A, name).requires_grad_(True)
    bt = torch.tensor(b, requires_grad=True)
    (solve(A, bt).abs() ** 2).sum().backward()
    return bt.grad, {name: getattr(A, name).grad for name in fields}


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_grad_per_buffer_matches_reference(system):
    make, strategy = SYSTEMS[system]
    data = make()
    Aj = gt.Csr.from_data(data, strategy="classical" if strategy ==
                          "classical" else "automatical")
    assert Aj.strategy == strategy
    A = _port_csr(Aj)
    n = data.shape[0]
    b = np.random.default_rng(1).standard_normal(n)
    solve_j = jmake(jcg.solve, criteria=JCRIT)
    gAj, gbj = jax.grad(lambda A, b: jnp.sum(solve_j(A, b) ** 2),
                        argnums=(0, 1), allow_int=True)(Aj, jnp.asarray(b))
    fields = [k for k in ("values", "diag_values", "tail_vals")
              if getattr(A, k) is not None]
    if system == "banded_tail":
        assert "tail_vals" in fields
    gb, gA = _loss_grads_port(make_differentiable_solve(
        cg.solve, criteria=CRIT), A, b, fields)
    _close(gb.numpy(), gbj)
    for name in fields:
        want = np.asarray(getattr(gAj, name))
        if not np.abs(want).max():
            np.testing.assert_array_equal(gA[name].numpy(), want, name)
        else:
            _close(gA[name].numpy(), want)
    if strategy == "banded":
        # the banded forward never reads `values`
        assert not gA["values"].any()
        assert gA["diag_values"].any()


def test_grad_wrt_rhs():
    """``tests/test_autodiff.py::test_grad_wrt_rhs``: against central
    differences and the reference."""
    data = _spd()
    Aj = gt.Csr.from_data(data)
    A = _port_csr(Aj)
    solve = make_differentiable_solve(cg.solve, criteria=CRIT)
    b = np.random.default_rng(1).standard_normal(12)
    bt = torch.tensor(b, requires_grad=True)

    def loss(v):
        return float((solve(A, torch.tensor(v)) ** 2).sum())

    (solve(A, bt) ** 2).sum().backward()
    eps = 1e-6
    g_fd = np.array([(loss(b + eps * e) - loss(b - eps * e)) / (2 * eps)
                     for e in np.eye(12)])
    np.testing.assert_allclose(bt.grad.numpy(), g_fd, rtol=1e-4, atol=1e-6)
    solve_j = jmake(jcg.solve, criteria=JCRIT)
    _close(bt.grad.numpy(), jax.grad(lambda b: jnp.sum(solve_j(Aj, b) ** 2))(
        jnp.asarray(b)))


def test_grad_wrt_matrix_values():
    """``test_grad_wrt_matrix_values``: classical values, central
    differences on four entries, zero on the padding, and the gradient of
    ``torch.linalg.solve`` through the same entries."""
    data = _spd(10, seed=2)
    A = _port_csr(gt.Csr.from_data(data))
    assert A.strategy == "classical" and A.values.shape[0] > A.nnz
    solve = make_differentiable_solve(cg.solve, criteria=CRIT)
    b = torch.tensor(np.random.default_rng(3).standard_normal(10))
    vals = A.values.clone().requires_grad_(True)
    A.values = vals
    (solve(A, b) ** 2).sum().backward()
    g = vals.grad.clone()
    assert not g[A.nnz:].any()
    eps = 1e-6
    for e in [0, 3, 7, A.nnz - 1]:
        def loss(delta):
            A.values = vals.detach().clone()
            A.values[e] += delta
            return float((solve(A, b) ** 2).sum())
        fd = (loss(eps) - loss(-eps)) / (2 * eps)
        np.testing.assert_allclose(float(g[e]), fd, rtol=1e-3, atol=1e-6)
    v = vals.detach().clone().requires_grad_(True)
    rows, cols = A.row_idx.long(), A.col_idx.long()
    keep = rows < 10
    dense = torch.zeros((10, 10), dtype=v.dtype).index_put(
        (rows[keep], cols[keep]), v[keep], accumulate=True)
    (torch.linalg.solve(dense, b) ** 2).sum().backward()
    _close(g.numpy(), v.grad.numpy())


def test_grad_dense_operator():
    """``test_grad_dense_operator``: the analytic -2 (A^-1 x) x^T, the
    reference and ``torch.linalg.solve``."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((6, 6))
    a = a @ a.T + 6 * np.eye(6)
    b = rng.standard_normal(6)
    solve = make_differentiable_solve(cg.solve, criteria=CRIT)
    data = torch.tensor(a, requires_grad=True)
    (solve(gtt.Dense(data), torch.tensor(b)) ** 2).sum().backward()
    x = np.linalg.solve(a, b)
    _close(data.grad.numpy(), -np.outer(np.linalg.solve(a, 2 * x), x), 1e-8)
    solve_j = jmake(jcg.solve, criteria=JCRIT)
    _close(data.grad.numpy(), jax.grad(lambda d: jnp.sum(solve_j(
        gt.Dense.create(d), jnp.asarray(b)) ** 2))(jnp.asarray(a)))
    ref = torch.tensor(a, requires_grad=True)
    (torch.linalg.solve(ref, torch.tensor(b)) ** 2).sum().backward()
    _close(data.grad.numpy(), ref.grad.numpy())


def test_grad_of_sum():
    """``test_grad_through_jit``'s function (torch has no jit of the host
    loop): d(sum x)/db = A^-T 1."""
    data = _spd(8, seed=5)
    A = _port_csr(gt.Csr.from_data(data))
    solve = make_differentiable_solve(cg.solve, criteria=CRIT)
    b = torch.ones(8, dtype=torch.float64, requires_grad=True)
    solve(A, b).sum().backward()
    want = np.linalg.solve(data.to_dense().T, np.ones(8))
    np.testing.assert_allclose(b.grad.numpy(), want, rtol=1e-7, atol=1e-9)


def test_grad_complex_operator_matches_linalg_solve():
    """``test_grad_complex_operator_matches_linalg_solve``: a complex HPD
    ``Dense``; the port equals ``torch.linalg.solve``'s gradients and the
    conjugate of the reference's."""
    rng = np.random.default_rng(7)
    n = 6
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = a @ a.conj().T + n * np.eye(n)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    solve = make_differentiable_solve(cg.solve, criteria=CRIT)
    data = torch.tensor(a, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    (solve(gtt.Dense(data), bt).abs() ** 2).sum().backward()
    ref_a = torch.tensor(a, requires_grad=True)
    ref_b = torch.tensor(b, requires_grad=True)
    (torch.linalg.solve(ref_a, ref_b).abs() ** 2).sum().backward()
    _close(data.grad.numpy(), ref_a.grad.numpy(), 1e-9)
    _close(bt.grad.numpy(), ref_b.grad.numpy(), 1e-9)
    solve_j = jmake(jcg.solve, criteria=JCRIT)
    gj = jax.grad(lambda d: jnp.sum(jnp.abs(solve_j(
        gt.Dense.create(d), jnp.asarray(b))) ** 2))(jnp.asarray(a))
    _close(data.grad.numpy(), np.conj(np.asarray(gj)))
    gbj = jax.grad(lambda v: jnp.sum(jnp.abs(solve_j(
        gt.Dense.create(jnp.asarray(a)), v)) ** 2))(jnp.asarray(b))
    _close(bt.grad.numpy(), np.conj(np.asarray(gbj)))


@pytest.mark.parametrize("complex_", [False, True])
def test_grad_coo(complex_):
    """A ``Coo`` (classical, no fast layout): values against the
    reference and ``torch.linalg.solve`` through the same entries;
    BiCGSTAB for the adjoint solve on the conjugate transpose."""
    data = _spd(12, seed=9)
    vals = data.values.astype(np.complex128) * (1 + 0.3j) if complex_ \
        else data.values
    d = MatrixData(data.shape, data.row_idx, data.col_idx, vals)
    A = gtt.Coo.from_data(d, fast=False, device="cpu")
    Aj = gt.Coo.from_data(gt.MatrixData(data.shape, data.row_idx,
                                        data.col_idx, vals), fast=False)
    np.testing.assert_array_equal(A.values.numpy(), np.asarray(Aj.values))
    rng = np.random.default_rng(10)
    b = rng.standard_normal(12) + (1j * rng.standard_normal(12)
                                   if complex_ else 0)
    solve = make_differentiable_solve(bicgstab.solve, criteria=CRIT)
    A.values.requires_grad_(True)
    (solve(A, torch.tensor(b)).abs() ** 2).sum().backward()
    from ginkgo_tpu.solver import bicgstab as jbicgstab
    solve_j = jmake(jbicgstab.solve, criteria=JCRIT)
    gj = jax.grad(lambda A: jnp.sum(jnp.abs(solve_j(A, jnp.asarray(b))) ** 2),
                  allow_int=True)(Aj)
    _close(A.values.grad.numpy(), np.conj(np.asarray(gj.values)))
    v = A.values.detach().clone().requires_grad_(True)
    keep = A.row_idx.long() < 12
    dense = torch.zeros((12, 12), dtype=v.dtype).index_put(
        (A.row_idx.long()[keep], A.col_idx.long()[keep]), v[keep],
        accumulate=True)
    (torch.linalg.solve(dense, torch.tensor(b)).abs() ** 2).sum().backward()
    _close(A.values.grad.numpy(), v.grad.numpy(), 1e-9)


def test_grad_multiple_rhs():
    """A (n, 2) right-hand side: the gradient sums over its columns."""
    data = _spd(12, seed=11)
    Aj = gt.Csr.from_data(data)
    A = _port_csr(Aj)
    b = np.random.default_rng(12).standard_normal((12, 2))
    gb, gA = _loss_grads_port(make_differentiable_solve(
        cg.solve, criteria=CRIT), A, b, ["values"])
    solve_j = jmake(jcg.solve, criteria=JCRIT)
    gAj, gbj = jax.grad(lambda A, b: jnp.sum(solve_j(A, b) ** 2),
                        argnums=(0, 1), allow_int=True)(Aj, jnp.asarray(b))
    _close(gb.numpy(), gbj)
    _close(gA["values"].numpy(), gAj.values)
