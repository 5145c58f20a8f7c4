"""The batch tier (``batch.py``): the port against ginkgo_tpu on the same
numpy inputs, on the CPU, in f64 as the reference's tests run.

The formats keep the reference's stored layout, so their arrays compare
exactly; applies, diagonals and ``add_scaled_identity`` to 1e-12.  The
solvers fold the lanes into the columns of one solve, where the reference
vmaps a whole solve; each lane's iterations, ``converged`` and
``stagnated`` must equal the reference's, and x agree to 1e-12 of its
largest entry — also where lanes converge at very different counts, where
``max_iterations`` stops some of them, and where the true-residual audit
rejects a lane's estimate (the per-lane counters of
``solver/common._run_lanes``)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginkgo_tpu import batch as jb
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.log import Record as JRecord
from ginkgo_tpu.log import capture as jcapture
from ginkgo_tpu.utils.generators import generate_random_matrix, make_spd
from ginkgo_tpu_torch import batch as tb
from ginkgo_tpu_torch.base.exceptions import UnsupportedMatrixProperty
from ginkgo_tpu_torch.base.matrix_data import MatrixData
from ginkgo_tpu_torch.interop import batch_from_arrays
from ginkgo_tpu_torch.log import Convergence, Record, Stream, capture

TOL = 1e-12
CPU = "cpu"


def _port_data(d):
    return MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


def _spd_pattern(n=24, seed=0):
    """Canonical, so that values in its entry order are the batch's
    stored order (``from_data`` canonicalizes the pattern alone)."""
    return make_spd(generate_random_matrix(
        n, n, nonzeros_per_row=(2, 5), seed=seed), shift=1.5).canonical()


def _batch_spd(nb=5, n=24, seed=0):
    """``tests/test_batch.py``'s batch: one SPD pattern, each entry's
    values scaled by a seeded factor."""
    pattern = _spd_pattern(n, seed)
    rng = np.random.default_rng(seed + 1)
    values = np.stack([pattern.values * rng.uniform(0.5, 2.0)
                       for _ in range(nb)])
    return pattern, values


def _both_csr(pattern, values):
    return (jb.BatchCsr.from_data((pattern, values)),
            tb.BatchCsr.from_data((_port_data(pattern), values), device=CPU))


def _both_ell(pattern, values):
    items = [JMatrixData(pattern.shape, pattern.row_idx, pattern.col_idx, v)
             for v in values]
    return (jb.BatchEll.from_data(items),
            tb.BatchEll.from_data([_port_data(it) for it in items],
                                  device=CPU))


def _both_dense(pattern, values):
    dense = np.stack([JMatrixData(pattern.shape, pattern.row_idx,
                                  pattern.col_idx, v).to_dense()
                      for v in values])
    return jb.BatchDense(data=jnp.asarray(dense)), tb.BatchDense(
        torch.tensor(dense))


BOTH = {"csr": _both_csr, "ell": _both_ell, "dense": _both_dense}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


# -- formats ------------------------------------------------------------------

def test_batch_csr_layout_equals_reference():
    pattern, values = _batch_spd()
    Aj, At = _both_csr(pattern, values)
    for name in ("row_idx", "col_idx", "row_ptr", "values"):
        np.testing.assert_array_equal(getattr(At, name).numpy(),
                                      np.asarray(getattr(Aj, name)))
    assert At.values.shape[1] % 8 == 0
    assert (At.row_idx[At.nnz:] == pattern.shape[0]).all()   # padding
    assert (At.shape, At.nnz) == (tuple(Aj.shape), Aj.nnz)


def test_batch_ell_layout_equals_reference():
    pattern, values = _batch_spd(nb=3, n=20, seed=6)
    Aj, At = _both_ell(pattern, values)
    for name in ("col_idx", "values", "row_lengths"):
        np.testing.assert_array_equal(getattr(At, name).numpy(),
                                      np.asarray(getattr(Aj, name)))
    assert (At.shape, At.nnz) == (tuple(Aj.shape), Aj.nnz)


@pytest.mark.parametrize("kind", ["BatchCsr", "BatchEll"])
def test_batch_from_arrays(kind):
    pattern, values = _batch_spd(nb=3, n=18, seed=2)
    Aj, At = (_both_csr if kind == "BatchCsr" else _both_ell)(pattern,
                                                              values)
    names = (("row_idx", "col_idx", "row_ptr", "values")
             if kind == "BatchCsr" else ("col_idx", "values", "row_lengths"))
    arrays = {name: np.asarray(getattr(Aj, name)) for name in names}
    B = batch_from_arrays(kind, arrays, {"shape": Aj.shape, "nnz": Aj.nnz},
                          device=CPU)
    b = np.random.default_rng(3).standard_normal((3, 18, 2))
    np.testing.assert_array_equal(B.apply(torch.tensor(b)).numpy(),
                                  At.apply(torch.tensor(b)).numpy())


@pytest.mark.parametrize("fmt", sorted(BOTH))
@pytest.mark.parametrize("k", [1, 3])
def test_batch_apply(fmt, k):
    pattern, values = _batch_spd(seed=4)
    Aj, At = BOTH[fmt](pattern, values)
    b = np.random.default_rng(2).standard_normal((values.shape[0], 24, k))
    _close(At.apply(torch.tensor(b)).numpy(), Aj.apply(jnp.asarray(b)))
    for i, v in enumerate(values):
        dense = JMatrixData(pattern.shape, pattern.row_idx, pattern.col_idx,
                            v).to_dense()
        _close(At.apply(torch.tensor(b))[i].numpy(), dense @ b[i])


def test_batch_csr_to_dense_batch():
    pattern, values = _batch_spd(nb=3)
    Aj, At = _both_csr(pattern, values)
    np.testing.assert_array_equal(At.to_dense_batch().numpy(),
                                  np.asarray(Aj.to_dense_batch()))


@pytest.mark.parametrize("fmt", sorted(BOTH))
def test_extract_diagonals(fmt):
    pattern, values = _batch_spd(seed=5)
    Aj, At = BOTH[fmt](pattern, values)
    np.testing.assert_array_equal(At.extract_diagonals().numpy(),
                                  np.asarray(Aj.extract_diagonals()))


@pytest.mark.parametrize("fmt", sorted(BOTH))
@pytest.mark.parametrize("scalars", ["scalar", "per_entry"])
def test_add_scaled_identity(fmt, scalars):
    pattern, values = _batch_spd(seed=7)
    Aj, At = BOTH[fmt](pattern, values)
    nb = values.shape[0]
    if scalars == "scalar":
        alpha, beta = 0.75, -1.5
    else:
        rng = np.random.default_rng(8)
        alpha, beta = rng.standard_normal(nb), rng.standard_normal(nb)
    Bj = Aj.add_scaled_identity(alpha, beta)
    Bt = At.add_scaled_identity(alpha, beta)
    _close(Bt.values.numpy(), Bj.values)
    b = np.random.default_rng(9).standard_normal((nb, 24, 2))
    _close(Bt.apply(torch.tensor(b)).numpy(), Bj.apply(jnp.asarray(b)))


def test_add_scaled_identity_multivector_scalars():
    pattern, values = _batch_spd(nb=3, seed=10)
    Aj, At = _both_csr(pattern, values)
    a = np.array([1.0, 2.0, 3.0]).reshape(3, 1, 1)
    Bj = Aj.add_scaled_identity(jb.BatchMultiVector(data=jnp.asarray(a)),
                                0.5)
    Bt = At.add_scaled_identity(tb.BatchMultiVector(torch.tensor(a)), 0.5)
    _close(Bt.values.numpy(), Bj.values)


@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_add_scaled_identity_raises_without_diagonal(fmt):
    # row 0 stores only (0, 1): its diagonal is structurally zero, and for
    # Ell its padded slot (col 0) must not count as one
    d = JMatrixData((3, 3), np.array([0, 1, 1, 2]), np.array([1, 0, 1, 2]),
                    np.array([1.0, 2.0, 3.0, 4.0]))
    values = np.stack([d.values, 2 * d.values])
    Aj, At = BOTH[fmt](d, values)
    with pytest.raises(Exception):
        Aj.add_scaled_identity(1.0, 1.0)
    with pytest.raises(UnsupportedMatrixProperty):
        At.add_scaled_identity(1.0, 1.0)


def test_pattern_mismatch_raises():
    a = generate_random_matrix(8, 8, nonzeros_per_row=(1, 3), seed=3)
    b = generate_random_matrix(8, 8, nonzeros_per_row=(1, 4), seed=4)
    assert a.canonical().nnz != b.canonical().nnz
    for make in (jb.BatchCsr.from_data, jb.BatchEll.from_data):
        with pytest.raises(ValueError):
            make([a, b])
    for make in (tb.BatchCsr.from_data, tb.BatchEll.from_data):
        with pytest.raises(ValueError, match="one sparsity pattern"):
            make([_port_data(a), _port_data(b)], device=CPU)


@pytest.mark.parametrize("complex_", [False, True])
def test_batch_multivector_reductions(complex_):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 7, 3))
    y = rng.standard_normal((4, 7, 3))
    if complex_:
        x = x + 1j * rng.standard_normal(x.shape)
        y = y + 1j * rng.standard_normal(y.shape)
    Xj, Xt = jb.BatchMultiVector(data=jnp.asarray(x)), tb.BatchMultiVector(
        torch.tensor(x))
    Yj, Yt = jb.BatchMultiVector(data=jnp.asarray(y)), tb.BatchMultiVector(
        torch.tensor(y))
    assert Xt.num_batch_items == 4 and Xt.shape == (7, 3)
    _close(Xt.compute_dot(Yt).numpy(), Xj.compute_dot(Yj))
    _close(Xt.compute_conj_dot(torch.tensor(y)).numpy(),
           Xj.compute_conj_dot(jnp.asarray(y)))
    _close(Xt.compute_norm2().numpy(), Xj.compute_norm2())
    _close(Xt.scale(0.5).data.numpy(), Xj.scale(0.5).data)
    _close(Xt.add_scaled(2.0, Yt).data.numpy(), Xj.add_scaled(2.0, Yj).data)


def test_batch_identity():
    b = torch.ones((2, 5, 1))
    I = tb.BatchIdentity(5, num_batch=2)
    assert I.shape == (5, 5) and I.apply(b) is b


# -- solvers -------------------------------------------------------------------

def _solve_both(name, Aj, At, b, *, precond=None, x0=None, generate=False,
                **kw):
    Pj = None if precond is None else jb.BatchJacobi(precond)
    Pt = None if precond is None else tb.BatchJacobi(precond)
    sj = getattr(jb, name)(preconditioner=Pj, **kw)
    st = getattr(tb, name)(preconditioner=Pt, **kw)
    x0j = None if x0 is None else jnp.asarray(x0)
    x0t = None if x0 is None else torch.tensor(x0)
    if generate:
        return (sj.generate(Aj).solve(jnp.asarray(b), x0j),
                st.generate(At).solve(torch.tensor(b), x0t))
    return (sj.solve(Aj, jnp.asarray(b), x0j),
            st.solve(At, torch.tensor(b), x0t))


def _same_result(rj, rt, b):
    for name in ("iterations", "converged", "stagnated"):
        got, want = getattr(rt, name).numpy(), np.asarray(getattr(rj, name))
        np.testing.assert_array_equal(got, want, err_msg=name)
    _close(rt.x.numpy(), rj.x)
    # the final residual norms are rounding-level vectors: they agree to
    # the solve's precision, relative to b
    np.testing.assert_allclose(rt.resnorm.numpy(), np.asarray(rj.resnorm),
                               rtol=0, atol=TOL * float(np.abs(b).max()))


@pytest.mark.parametrize("name", ["BatchCg", "BatchBicgstab"])
@pytest.mark.parametrize("precond", [None, 1, 4])
@pytest.mark.parametrize("tol_type", ["relative", "absolute"])
def test_batch_solver_matches_reference(name, precond, tol_type):
    pattern, values = _batch_spd(nb=6, n=24, seed=0)
    Aj, At = _both_csr(pattern, values)
    b = np.random.default_rng(1).standard_normal((6, 24, 2))
    rj, rt = _solve_both(name, Aj, At, b, precond=precond,
                         max_iterations=200, tolerance=1e-10,
                         tolerance_type=tol_type)
    assert bool(rt.converged.all())
    _same_result(rj, rt, b)
    assert rt.x.shape == (6, 24, 2) and rt.iterations.shape == (6, 2)


@pytest.mark.parametrize("name", ["BatchCg", "BatchBicgstab"])
def test_batch_solver_vector_rhs(name):
    """A 2-D b: x (nb, n), iterations/resnorm/converged (nb,); against the
    true solution, as ``tests/test_batch.py::test_batch_solver``."""
    pattern, values = _batch_spd(nb=6, n=20, seed=8)
    Aj, At = _both_csr(pattern, values)
    x_true = np.random.default_rng(9).standard_normal((6, 20))
    b = np.einsum("bnm,bm->bn", At.to_dense_batch().numpy(), x_true)
    rj, rt = _solve_both(name, Aj, At, b, max_iterations=200,
                         tolerance=1e-10)
    _same_result(rj, rt, b)
    assert rt.x.shape == (6, 20) and rt.iterations.shape == (6,)
    assert rt.converged.shape == rt.resnorm.shape == (6,)
    np.testing.assert_allclose(rt.x.numpy(), x_true, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["BatchCg", "BatchBicgstab"])
@pytest.mark.parametrize("precond", [None, 1, 4])
def test_batch_solver_generate_api(name, precond):
    pattern, values = _batch_spd(nb=3, n=16, seed=14)
    Aj, At = _both_csr(pattern, values)
    b = np.random.default_rng(15).standard_normal((3, 16, 2))
    rj, rt = _solve_both(name, Aj, At, b, precond=precond, generate=True,
                         max_iterations=200, tolerance=1e-9)
    _same_result(rj, rt, b)
    gen = getattr(tb, name)(max_iterations=200, tolerance=1e-9).generate(At)
    _close(gen.apply(torch.tensor(b)).numpy(), gen.solve(
        torch.tensor(b)).x.numpy(), 0.0)


@pytest.mark.parametrize("fmt", ["ell", "dense"])
@pytest.mark.parametrize("precond", [None, 4])
def test_batch_solver_other_formats(fmt, precond):
    pattern, values = _batch_spd(nb=4, n=16, seed=20)
    Aj, At = BOTH[fmt](pattern, values)
    b = np.random.default_rng(21).standard_normal((4, 16, 2))
    rj, rt = _solve_both("BatchCg", Aj, At, b, precond=precond,
                         max_iterations=200, tolerance=1e-10)
    _same_result(rj, rt, b)
    # the same systems through BatchCsr
    _, Ct = _both_csr(pattern, values)
    rc = tb.BatchCg(max_iterations=200, tolerance=1e-10,
                    preconditioner=None if precond is None
                    else tb.BatchJacobi(precond)).solve(Ct, torch.tensor(b))
    _close(rt.x.numpy(), rc.x.numpy())


def test_batch_solver_initial_guess():
    pattern, values = _batch_spd(nb=3, n=16, seed=22)
    Aj, At = _both_csr(pattern, values)
    rng = np.random.default_rng(23)
    b, x0 = rng.standard_normal((3, 16)), rng.standard_normal((3, 16))
    rj, rt = _solve_both("BatchBicgstab", Aj, At, b, x0=x0,
                         max_iterations=200, tolerance=1e-10)
    _same_result(rj, rt, b)


def _tridiagonal(n):
    r = np.arange(n)
    rows = np.concatenate([r, r[1:], r[:-1]])
    cols = np.concatenate([r, r[1:] - 1, r[:-1] + 1])
    return JMatrixData((n, n), rows, cols, np.ones(rows.size)).canonical()


# lane shifts of -1, 2 + s, -1: lane 0 converges in about 25 iterations,
# lane 4 needs 100; lane 0's right-hand side is scaled by 1e9, so its
# f64 true residual cannot meet the absolute tolerance its recurrent
# residual reaches: the audit rejects it
SHIFTS = (3.0, 1.0, 0.3, 0.1, 1e-4)


@pytest.mark.parametrize("max_iterations", [60, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_cg_lanes_audit_and_cap(max_iterations, seed):
    """Lanes converging at 24-100 iterations with k = 2 each; one lane's
    estimate is rejected twice by the true-residual audit and ends
    stagnated after 39 iterations of its own.  With max_iterations = 60,
    two lanes stop at the cap, and the rejected lane still gets its own
    iterations and audit rounds: a loop counting iterations for all lanes
    at once would stop it at the slow lanes' 60."""
    n = 100
    pattern = _tridiagonal(n)
    values = np.stack([np.where(pattern.row_idx == pattern.col_idx,
                                2.0 + s, -1.0) for s in SHIFTS])
    Aj, At = _both_csr(pattern, values)
    b = np.random.default_rng(seed).standard_normal((len(SHIFTS), n, 2))
    b[0] *= 1e9
    rj, rt = _solve_both("BatchCg", Aj, At, b,
                         max_iterations=max_iterations, tolerance=1e-9,
                         tolerance_type="absolute")
    for name in ("iterations", "converged", "stagnated"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)),
                                      err_msg=name)
    iters, conv = rt.iterations.numpy(), rt.converged.numpy()
    assert rt.stagnated[0].all() and not conv[0].any()
    assert (iters[0] == 39).all()
    assert conv[1:3].all() and iters[1].max() < iters[2].min()
    if max_iterations == 60:
        assert (iters[3:] == 60).all() and not conv[3:].any()
    else:
        assert conv[1:].all() and (iters[4] == 100).all()
    # x where the lanes converged (the rejected lane's x sits at its
    # rounding floor, and the capped lanes' x are unfinished iterates)
    _close(rt.x[1:3].numpy(), rj.x[1:3])


def test_batch_solve_completed_event():
    from ginkgo_tpu_torch.utils.generators import stencil_2d
    data = stencil_2d(5, points=5)
    vals = np.stack([data.canonical().values] * 3)
    A = tb.BatchCsr.from_data((data, vals), device=CPU)
    buf = io.StringIO()
    with capture(Record(), Convergence(), Stream(buf)) as (rec, conv, _):
        res = tb.BatchCg(max_iterations=100, tolerance=1e-8).solve(
            A, torch.ones((3, 25), dtype=torch.float64))
    assert bool(res.converged.all())
    evts = [d for e, d in rec.data if e == "batch_solve_completed"]
    assert len(evts) == 1 and evts[0]["num_systems"] == 3
    assert evts[0]["result"] is res
    # the folded solve's own events stay inside the batch solve, as the
    # reference's vmapped solve fires none
    assert [e for e, _ in rec.data] == ["batch_solve_completed"]
    assert conv.result is None
    assert "batch_solve_completed" in buf.getvalue()
    jdata = JMatrixData(data.shape, data.row_idx, data.col_idx, data.values)
    with jcapture(JRecord()) as jrec:
        jb.BatchCg(max_iterations=100, tolerance=1e-8).solve(
            jb.BatchCsr.from_data((jdata, vals)), jnp.ones((3, 25)))
    assert [e for e, _ in jrec.data] == ["batch_solve_completed"]


def test_batch_entry_points_default_to_cuda(monkeypatch):
    pattern, values = _batch_spd(nb=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        tb.BatchCsr.from_data((_port_data(pattern), values))
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        tb.BatchEll.from_data([_port_data(pattern)])
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        tb.BatchDense(np.ones((2, 3, 3)))
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        batch_from_arrays("BatchEll", {"col_idx": np.zeros((2, 1)),
                                       "row_lengths": np.ones(2),
                                       "values": np.ones((1, 2, 1))},
                          {"shape": (2, 2), "nnz": 2})
