"""Multigrid (``multigrid/pgm.py``, ``pgm_dia.py``, ``pgm_packed.py``,
``solver/multigrid.py``): the port against ginkgo_tpu on the same numpy
inputs, on the CPU, in f64 as the reference's tests run.

Aggregation is held index for index on every path (the host matching,
deterministic and seeded, and the ``dia`` and ``packed`` device
matchers, whose int64 hash must give the reference's uint32 bits);
Galerkin operators and level operators exactly; multigrid solves to the
reference's iteration counts with x at 1e-10 (sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.multigrid import pgm as jpgm
from ginkgo_tpu.multigrid import pgm_dia as jdia
from ginkgo_tpu.multigrid import pgm_packed as jpacked
from ginkgo_tpu.solver import Cg as JCg
from ginkgo_tpu.solver import Multigrid as JMultigrid
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu_torch.base.exceptions import NotSupportedError
from ginkgo_tpu_torch.base.matrix_data import MatrixData
from ginkgo_tpu_torch.interop import (INDEX_ARRAYS, SLAB_ARRAYS,
                                      STATIC_FIELDS, VALUE_ARRAYS,
                                      multigrid_from_arrays)
from ginkgo_tpu_torch.multigrid import FixedCoarsening, Pgm
from ginkgo_tpu_torch.multigrid import pgm as tpgm
from ginkgo_tpu_torch.multigrid import pgm_dia as tdia
from ginkgo_tpu_torch.multigrid import pgm_packed as tpacked
from ginkgo_tpu_torch.solver import Cg, Multigrid
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import stencil_2d, stencil_3d

X_TOL = 1e-10


def _random_2000():
    """``test_pgm_packed_matches_host_quality``'s unstructured matrix."""
    rng = np.random.default_rng(4)
    n, per = 2000, 5
    r = np.repeat(np.arange(n), per)
    c = np.clip(r + rng.integers(-60, 60, r.size), 0, n - 1)
    v = -np.abs(rng.standard_normal(r.size))
    rows = np.concatenate([r, c, np.arange(n)])
    cols = np.concatenate([c, r, np.arange(n)])
    vals = np.concatenate([v, v, np.full(n, 12.0)])
    return MatrixData((n, n), rows, cols, vals).canonical()


def _heavy_rows():
    """A 600-row matrix whose first rows couple to 150 others: the
    packed matcher keeps each row's 64 strongest edges."""
    rng = np.random.default_rng(9)
    n = 600
    r = np.concatenate([np.repeat(np.arange(3), 150),
                        np.repeat(np.arange(n), 4)])
    c = np.concatenate([rng.choice(np.arange(3, n), 450),
                        np.clip(np.repeat(np.arange(n), 4)
                                + rng.integers(-9, 9, 4 * n), 0, n - 1)])
    v = -np.abs(rng.standard_normal(r.size))
    return MatrixData((n, n), np.concatenate([r, c, np.arange(n)]),
                      np.concatenate([c, r, np.arange(n)]),
                      np.concatenate([v, v, np.full(n, 20.0)])).canonical()


CASES = {"stencil3d_27": lambda: stencil_3d(8, points=27),
         "stencil2d_9": lambda: stencil_2d(24, points=9),
         "stencil3d_7": lambda: stencil_3d(6, points=7),
         "random2000": _random_2000,
         "heavy_rows": _heavy_rows}


def _jd(d):
    return gt.MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


def _both(data, **kw):
    return (gtt.Csr.from_data(data, device="cpu", **kw),
            gt.Csr.from_data(_jd(data), **kw))


def _jax_arrays(A):
    """A ginkgo_tpu Csr as ``csr_from_arrays``' (arrays, static)."""
    names = INDEX_ARRAYS + VALUE_ARRAYS + tuple(SLAB_ARRAYS)
    arrays = {k: None if getattr(A, k) is None else np.asarray(getattr(A, k))
              for k in names}
    return arrays, {k: getattr(A, k) for k in STATIC_FIELDS}


def _assert_csr_equal(At, Aj):
    a, b = At.to_matrix_data(), Aj.to_matrix_data()
    assert At.shape == Aj.shape and At.strategy == Aj.strategy
    np.testing.assert_array_equal(a.row_idx, b.row_idx)
    np.testing.assert_array_equal(a.col_idx, b.col_idx)
    np.testing.assert_array_equal(a.values, np.asarray(b.values))


# -- aggregation --------------------------------------------------------------

@pytest.mark.parametrize("seed", [None, 0, 7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pgm_aggregate_general_equal(case, seed):
    """The host matching, deterministic (``seed`` None) and with the
    seeded random tiebreak: agg equal index for index."""
    d = CASES[case]()
    kw = (dict(deterministic=True) if seed is None
          else dict(deterministic=False, seed=seed))
    got = tpgm.pgm_aggregate(d, algorithm="general", device="cpu", **kw)
    want = jpgm.pgm_aggregate(_jd(d), algorithm="general", **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["stencil3d_27", "stencil2d_9",
                                  "stencil3d_7"])
def test_dia_matcher_equal(case):
    d = CASES[case]().canonical()
    np.testing.assert_array_equal(tdia.plan_offsets(d),
                                  jdia.plan_offsets(_jd(d)))
    root = tdia.aggregate_dia(d, device="cpu")
    np.testing.assert_array_equal(root, jdia.aggregate_dia(_jd(d)))
    agg, route = tpgm.aggregate(d, algorithm="dia", device="cpu")
    assert route == "dia"
    np.testing.assert_array_equal(
        agg, jpgm.pgm_aggregate(_jd(d), algorithm="dia"))
    assert agg[0] == 0 and np.bincount(agg).min() >= 1


def test_dia_symmetrize_and_key_bits():
    """The mirrored slab and the tiebroken key equal the reference's bit
    for bit (the key through the int64 hash)."""
    d = stencil_3d(8, points=27).canonical()
    offs = tdia.plan_offsets(d)
    n = d.shape[0]
    rng = np.random.default_rng(2)
    slab = rng.random((offs.size, n)).astype(np.float32)
    qneg = np.searchsorted(offs, -offs)
    got = tdia._symmetrize(torch.from_numpy(slab), torch.from_numpy(qneg),
                           torch.from_numpy(offs))
    want = jdia._symmetrize(jnp.asarray(slab), jnp.asarray(qneg, jnp.int32),
                            jnp.asarray(offs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the hash over the full 32-bit range: the reference's uint32 bits
    lo = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    hi = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    w = rng.random(4096).astype(np.float32)
    key = tdia.edge_key(torch.from_numpy(w),
                        torch.from_numpy(lo.astype(np.int64)),
                        torch.from_numpy(hi.astype(np.int64)))
    ju = jnp.asarray(lo.astype(np.uint32))
    jv = jnp.asarray(hi.astype(np.uint32))
    h = (ju * jnp.uint32(2654435761)) ^ (jv * jnp.uint32(2246822519))
    h = (h ^ (h >> 15)) * jnp.uint32(0x85EBCA6B)
    u01 = (h >> 9).astype(jnp.float32) * jnp.float32(2.0 ** -23)
    jkey = jnp.asarray(w) * (jnp.float32(1.0) + u01 * jnp.float32(2.0 ** -12))
    np.testing.assert_array_equal(key.numpy().view(np.uint32),
                                  np.asarray(jkey).view(np.uint32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_matcher_equal(case):
    d = CASES[case]().canonical()
    root = tpacked.aggregate_packed(d, device="cpu")
    np.testing.assert_array_equal(root, jpacked.aggregate_packed(_jd(d)))
    agg, route = tpgm.aggregate(d, algorithm="packed", device="cpu")
    assert route == "packed"
    np.testing.assert_array_equal(
        agg, jpgm.pgm_aggregate(_jd(d), algorithm="packed"))


def test_routing():
    """``auto`` on the CPU takes the host path at any size; a named
    matcher that declines goes on to the host path on the CPU and raises
    for a CUDA operand (nothing reaches the card before the plan
    declines)."""
    rnd = _random_2000()
    assert tdia.plan_offsets(rnd) is None
    assert tpgm.aggregate(rnd, algorithm="dia", device="cpu")[1] == "host"
    with pytest.raises(NotSupportedError, match="dia matcher declines"):
        tpgm.aggregate(rnd, algorithm="dia", device="cuda")
    diag = MatrixData((64, 64), np.arange(64), np.arange(64), np.ones(64))
    with pytest.raises(NotSupportedError, match="packed matcher declines"):
        tpgm.aggregate(diag, algorithm="packed", device="cuda")
    # the host path on a large stencil: 16,384 rows, the device cut
    big = stencil_2d(128, points=5)
    assert tpgm.aggregate(big, device="cpu")[1] == "host"
    with pytest.raises(ValueError, match="unknown algorithm"):
        tpgm.aggregate(big, algorithm="nope", device="cpu")
    A = gtt.Csr.from_data(stencil_3d(6, points=7), device="cpu")
    assert Pgm(algorithm="dia").generate(A).route == "dia"
    assert Pgm(algorithm="packed").generate(A).route == "packed"
    assert Pgm().generate(A).route == "host"


def test_galerkin_coarse_equal():
    d = stencil_2d(6, points=5)
    agg = tpgm.pgm_aggregate(d, device="cpu")
    nc = int(agg.max()) + 1
    got = tpgm.galerkin_coarse(d, agg, nc)
    want = jpgm.galerkin_coarse(_jd(d), agg, nc)
    assert got.shape == want.shape
    for field in ("row_idx", "col_idx", "values"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(want, field)))
    n = d.shape[0]
    P = np.zeros((n, nc))
    P[np.arange(n), agg] = 1.0
    np.testing.assert_allclose(got.to_dense(), P.T @ d.to_dense() @ P,
                               rtol=1e-12)


@pytest.mark.parametrize("nx", [6, 96])
def test_pgm_level_operators(nx):
    """``Pgm().generate``: agg, coarse operator and (at 9,216 rows) the
    packed P and R equal the reference's; R P = diag of the aggregate
    sizes."""
    At, Aj = _both(stencil_2d(nx, points=5))
    lvl, lj = Pgm().generate(At), jpgm.Pgm().generate(Aj)
    assert lvl.route == "host" and lvl.fine_op is At
    np.testing.assert_array_equal(lvl.prolong.agg.numpy(),
                                  np.asarray(lj.prolong.agg))
    _assert_csr_equal(lvl.coarse_op, lj.coarse_op)
    for mine, theirs in ((lvl.prolong.op, lj.prolong.op),
                         (lvl.restrict.op, lj.restrict.op)):
        assert (mine is None) == (theirs is None) == (nx < 90)
        if mine is not None:
            assert mine.strategy == "packed"
            _assert_csr_equal(mine, theirs)
    nc = lvl.coarse_op.shape[0]
    b = np.random.default_rng(0).standard_normal((nc, 2))
    up = lvl.prolong.apply(torch.from_numpy(b))
    down = lvl.restrict.apply(up)
    sizes = np.bincount(lvl.prolong.agg.numpy(), minlength=nc)[:, None]
    np.testing.assert_allclose(down.numpy(), sizes * b, rtol=1e-12)
    np.testing.assert_allclose(up.numpy(), np.asarray(
        lj.prolong.apply(jnp.asarray(b))), rtol=1e-15)


def test_fixed_coarsening_equal():
    At, Aj = _both(stencil_2d(8, points=5))
    sel = np.arange(0, 64, 2)
    lvl = FixedCoarsening(coarse_rows=sel).generate(At)
    lj = jpgm.FixedCoarsening(coarse_rows=sel).generate(Aj)
    assert lvl.route == "fixed"
    _assert_csr_equal(lvl.coarse_op, lj.coarse_op)
    b = np.random.default_rng(2).standard_normal(64)
    np.testing.assert_array_equal(lvl.restrict.apply(torch.from_numpy(b)),
                                  b[sel])
    xc = np.random.default_rng(3).standard_normal(32)
    np.testing.assert_array_equal(
        lvl.prolong.apply(torch.from_numpy(xc)).numpy(),
        np.asarray(lj.prolong.apply(jnp.asarray(xc))))


# -- solves -------------------------------------------------------------------

@pytest.mark.parametrize("cycle", ["v", "w", "f", "k"])
def test_multigrid_solver_cycles(cycle):
    At, Aj = _both(stencil_2d(16, points=5))
    n = At.shape[0]
    x_true = np.random.default_rng(1).standard_normal(n)
    b = np.array(Aj.apply(jnp.asarray(x_true)))
    mg = Multigrid.build(cycle=cycle, criteria=Iteration(100)
                         | ResidualNorm(1e-10)).generate(At)
    res = mg.solve(torch.from_numpy(b))
    want = JMultigrid.build(cycle=cycle, criteria=JIteration(100)
                            | JResidualNorm(1e-10)).generate(Aj).solve(
                                jnp.asarray(b))
    assert bool(res.converged.all())
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x),
                               rtol=X_TOL, atol=X_TOL)
    np.testing.assert_allclose(res.x.numpy(), x_true, rtol=1e-6, atol=1e-7)
    # the solver as a LinOp, and the same hierarchy as one cycle
    np.testing.assert_array_equal(mg.apply(torch.from_numpy(b)).numpy(),
                                  res.x.numpy())
    assert mg.cycle_operator().shape == (n, n)


def _reference_hierarchy(mj):
    levels = []
    for lvl in mj.levels:
        levels.append(dict(
            agg=np.asarray(lvl.prolong.agg),
            coarse=_jax_arrays(lvl.coarse_op),
            prolong=None if lvl.prolong.op is None
            else _jax_arrays(lvl.prolong.op),
            restrict=None if lvl.restrict.op is None
            else _jax_arrays(lvl.restrict.op)))
    return (levels, np.asarray(mj.coarsest.inv),
            [np.asarray(s.inv_diag) for s in mj.smoothers])


@pytest.mark.parametrize("source", ["carried", "generated"])
def test_mg_cg(source):
    """MG-preconditioned CG on ``stencil_3d(8, points=7)``, b = ones: on
    the reference's own hierarchy carried across (``carried``: the cycle's
    arithmetic alone) and on the port's generate (``generated``)."""
    data = stencil_3d(8, points=7)
    At, Aj = _both(data)
    mj = JMultigrid.build().generate(Aj)
    if source == "carried":
        levels, inv, inv_diags = _reference_hierarchy(mj)
        mg = multigrid_from_arrays(_jax_arrays(Aj), levels, inv, inv_diags,
                                   device="cpu")
        assert [lvl.route for lvl in mg.levels] == ["carried"] * len(levels)
    else:
        mg = Multigrid.build().generate(At)
    assert [lvl.fine_op.shape for lvl in mg.levels] == \
        [lvl.fine_op.shape for lvl in mj.levels]
    crit = Iteration(500) | ResidualNorm(1e-10)
    res = Cg.solve(At, torch.ones(512, dtype=torch.float64), criteria=crit,
                   preconditioner=mg.cycle_operator())
    want = JCg.solve(Aj, jnp.ones(512), criteria=JIteration(500)
                     | JResidualNorm(1e-10),
                     preconditioner=mj.cycle_operator())
    plain = Cg.solve(At, torch.ones(512, dtype=torch.float64), criteria=crit)
    assert bool(res.converged.all())
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(want.iterations))
    assert int(res.iterations[0]) < int(plain.iterations[0])
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x),
                               rtol=X_TOL, atol=X_TOL)


def test_mixed_precision_multigrid():
    """``coarse_dtype=float32`` over an f64 fine level: the coarse levels
    stored in f32, the casts at the transfer operators; the reference's
    iteration count, x at 1e-10."""
    At, Aj = _both(stencil_2d(16, points=5))
    crit = Iteration(100) | ResidualNorm(1e-9)
    mg = Multigrid.build(coarse_dtype=torch.float32,
                         criteria=crit).generate(At)
    mj = JMultigrid.build(coarse_dtype=jnp.float32,
                          criteria=JIteration(100)
                          | JResidualNorm(1e-9)).generate(Aj)
    assert mg.levels[0].fine_op.dtype == torch.float64
    assert all(lvl.coarse_op.dtype == torch.float32 for lvl in mg.levels)
    assert mg.levels[0].prolong.out_dtype == torch.float64
    assert mg.levels[0].restrict.out_dtype == torch.float32
    res = mg.solve(torch.ones(256, dtype=torch.float64))
    want = mj.solve(jnp.ones(256))
    assert res.x.dtype == torch.float64 and bool(res.converged.all())
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x),
                               rtol=X_TOL, atol=X_TOL)


def test_multigrid_hierarchy_and_factory():
    At, _ = _both(stencil_2d(20, points=5))
    mg = Multigrid.build(min_coarse_rows=10, max_levels=10).generate(At)
    sizes = [lvl.fine_op.shape[0] for lvl in mg.levels]
    assert len(sizes) >= 2 and all(a > b for a, b in zip(sizes, sizes[1:]))
    assert mg.coarsest.shape[0] <= sizes[-1]
    with pytest.raises(ValueError, match="unknown multigrid cycle"):
        Multigrid(cycle="x")
    # a factory as a preconditioner, the solver reached through the
    # package's lazy namespace
    res = gtt.solver.Cg.solve(At, torch.ones(400, dtype=torch.float64),
                              criteria=Iteration(300) | ResidualNorm(1e-10),
                              preconditioner=mg.cycle_operator())
    assert bool(res.converged.all())


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stencil3d_27", "random2000"])
def test_card_matchers_equal_cpu(case):
    """The card's ``dia`` and ``packed`` roots equal the CPU's index for
    index: the int64 hash gives the same bits on CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = CASES[case]().canonical()
    for fn in (tdia.aggregate_dia, tpacked.aggregate_packed):
        cpu = fn(d, device="cpu")
        if cpu is None:
            continue
        np.testing.assert_array_equal(fn(d, device="cuda"), cpu)
