"""The precision tiers (``base/precision.py``, ``base/accessor.py``,
``ops/df64.py``, ``ops/dc64.py``) and the port's top level: the port
against ginkgo_tpu on the same numpy inputs, on the CPU.

The double-word primitives must give the reference's bits on f32 inputs
(both run each f32 operation rounded on its own, with no FMA); the
iterative refinements, whose inner solves sum in another order, are held
to the reference's history at 1e-12 relative (ir_df64) and to the
reference tests' residual pins (5e-11 and 1e-11)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.base import accessor as jacc
from ginkgo_tpu.base.precision import (
    precision_dispatch as jpd, precision_dispatch_real_complex as jpdrc)
from ginkgo_tpu.ops import dc64 as JC
from ginkgo_tpu.ops import df64 as JD
from ginkgo_tpu.solver import cg as jcg
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu_torch.base import accessor as tacc
from ginkgo_tpu_torch.ops import dc64 as TC
from ginkgo_tpu_torch.ops import df64 as TD
from ginkgo_tpu_torch.solver import Cg, cg as tcg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import stencil_2d, stencil_3d


def _f32(rng, n, scale=1.0):
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits_equal(got, want):
    """Each tensor of ``got`` equals the matching array of ``want`` bit
    for bit (same type, same values)."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _bits_equal(g, w)
        return
    w = np.asarray(want)
    g = got.numpy()
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def _jd(data):
    return gt.MatrixData(data.shape, data.row_idx, data.col_idx, data.values)


# -- the top level ------------------------------------------------------------

def test_lazy_submodules_and_exports():
    import importlib
    import pathlib
    import subprocess
    import sys
    # a fresh interpreter: nothing imported the subpackages beforehand
    code = ("import ginkgo_tpu_torch as g; g.solver.Cg; g.multigrid.Pgm; "
            "g.stop.ResidualNorm; g.factorization; g.reorder; g.log; "
            "g.preconditioner; g.benchmark; g.utils; "
            "g.precision_dispatch; g.precision_dispatch_real_complex; "
            "print(sorted(g.version_info.get()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(pathlib.Path(gtt.__file__).parents[1]))
    assert out.returncode == 0, out.stderr
    assert "ginkgo_tpu_torch" in out.stdout and "torch" in out.stdout
    assert gtt.solver.Multigrid is importlib.import_module(
        "ginkgo_tpu_torch.solver.multigrid").Multigrid
    assert gtt.distributed.Partition is importlib.import_module(
        "ginkgo_tpu_torch.distributed.partition").Partition
    with pytest.raises(AttributeError):
        gtt.not_a_module


def test_version_info():
    v = gtt.version_info.get()
    assert v["ginkgo_tpu_torch"] == gtt.__version__
    assert v["torch"] == torch.__version__
    assert v["cuda"] == torch.version.cuda
    assert set(v["tiers"]) == {"reference", "cuda", "host"}


# -- precision dispatch -------------------------------------------------------

def test_precision_dispatch():
    data = stencil_2d(6, points=5)
    A32 = gtt.Csr.from_data(data, dtype=np.float32, device="cpu")
    Aj = gt.Csr.from_data(_jd(data), dtype=np.float32)
    b = np.ones(36)
    res = gtt.precision_dispatch(
        lambda A, b, **kw: tcg.solve(A, b, **kw), A32, torch.from_numpy(b),
        criteria=Iteration(300) | ResidualNorm(1e-6))
    want = jpd(lambda A, b, **kw: jcg.solve(A, b, **kw), Aj,
               jnp.asarray(b), criteria=JIteration(300)
               | JResidualNorm(1e-6))
    assert res.x.dtype == torch.float64          # converted back
    assert bool(res.converged.all())
    assert int(res.iterations[0]) == int(want.iterations[0])
    # f32 CG, sums in another order: 1e-5 relative
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x),
                               rtol=1e-5, atol=1e-5)
    # an operator result (no .x) is converted back too
    y = gtt.precision_dispatch(lambda A, b: A.apply(b), A32,
                               torch.ones(36, dtype=torch.float64))
    assert y.dtype == torch.float64


def test_precision_dispatch_complex_over_real():
    data = stencil_2d(5, points=5)
    A = gtt.Csr.from_data(data, device="cpu")
    Aj = gt.Csr.from_data(_jd(data))
    rng = np.random.default_rng(0)
    b = rng.standard_normal(25) + 1j * rng.standard_normal(25)
    res = gtt.precision_dispatch_real_complex(
        lambda A, bb, **kw: tcg.solve(A, bb, **kw), A, torch.from_numpy(b),
        criteria=Iteration(300) | ResidualNorm(1e-11))
    want = jpdrc(lambda A, bb, **kw: jcg.solve(A, bb, **kw), Aj,
                 jnp.asarray(b), criteria=JIteration(300)
                 | JResidualNorm(1e-11))
    assert res.x.dtype == torch.complex128 and res.x.shape == (25,)
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(want.iterations))
    # f64, sums in another order: 1e-10
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x),
                               rtol=1e-10, atol=1e-12)
    exact = np.linalg.solve(data.to_dense(), b)
    np.testing.assert_allclose(res.x.numpy(), exact, rtol=1e-7, atol=1e-8)


# -- accessors ----------------------------------------------------------------

@pytest.mark.parametrize("storage", ["bfloat16", "float16"])
def test_reduced_row_major_bits(storage):
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((6, 40)).astype(np.float32)
    row = rng.standard_normal(40).astype(np.float32)
    jdt = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}[storage]
    tdt = getattr(torch, storage)
    ja = jacc.ReducedRowMajor.from_array(jnp.asarray(arr), jdt)
    ta = tacc.ReducedRowMajor.from_array(torch.from_numpy(arr), tdt)
    _bits_equal(ta.read(), ja.read())
    jb = ja.write(2, jnp.asarray(row))
    tb = ta.write(2, torch.from_numpy(row))
    _bits_equal(tb.read(), jb.read())
    _bits_equal(tb.read(2), jb.read(2))
    # write returns a new accessor; the old one is unchanged
    _bits_equal(ta.read(), ja.read())
    assert ta.storage is not tb.storage
    assert tb.arith_dtype == torch.float32 and tb.shape == (6, 40)
    c = tacc.ReducedRowMajor.create((3, 4), tdt, device="cpu")
    assert c.storage.dtype == tdt and not bool(c.read().any())


@pytest.mark.parametrize("int_dtype", ["int16", "int8"])
def test_scaled_reduced_row_major_bits(int_dtype):
    rng = np.random.default_rng(4)
    ta = tacc.ScaledReducedRowMajor.create((5, 64), getattr(torch, int_dtype),
                                           device="cpu")
    ja = jacc.ScaledReducedRowMajor.create((5, 64), getattr(jnp, int_dtype))
    rows = [_f32(rng, 64, s) for s in (1.0, 1e-3, 250.0)]
    rows.append(np.zeros(64, np.float32))
    for i, row in enumerate(rows):
        before = ta.q.clone(), ta.scale.clone()
        nt = ta.write(i, torch.from_numpy(row))
        ja = ja.write(i, jnp.asarray(row))
        # the old accessor is unchanged
        assert torch.equal(ta.q, before[0]) and torch.equal(ta.scale,
                                                            before[1])
        ta = nt
        np.testing.assert_array_equal(ta.q.numpy(), np.asarray(ja.q))
        _bits_equal(ta.scale, ja.scale)
        _bits_equal(ta.read(i), ja.read(i))
    _bits_equal(ta.read(), ja.read())
    assert ta.shape == (5, 64)


# -- df64 ---------------------------------------------------------------------

def test_two_sum_two_prod_error_free():
    rng = np.random.default_rng(0)
    a, b = _f32(rng, 1000), _f32(rng, 1000, 1e-4)
    s, e = TD.two_sum(_t(a), _t(b))
    exact = a.astype(np.float64) + b.astype(np.float64)
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(),
                                  exact)
    p, e2 = TD.two_prod(_t(a), _t(b))
    exactp = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(p.double().numpy() + e2.double().numpy(),
                                  exactp)


def test_df_primitives_bits():
    rng = np.random.default_rng(5)
    x = [_f32(rng, 777, s) for s in (3.0, 1e-8, 2.0, 1e-9)]
    xt, xj = [_t(v) for v in x], [jnp.asarray(v) for v in x]
    for name in ("two_sum", "quick_two_sum", "two_prod"):
        _bits_equal(getattr(TD, name)(xt[0], xt[2]),
                    getattr(JD, name)(xj[0], xj[2]))
    _bits_equal(TD.split(xt[0]), JD.split(xj[0]))
    for name in ("df_add", "df_mul", "df_div"):
        _bits_equal(getattr(TD, name)(*xt), getattr(JD, name)(*xj))
    for name in ("df_add_f32", "df_mul_f32"):
        _bits_equal(getattr(TD, name)(*xt[:3]), getattr(JD, name)(*xj[:3]))
    _bits_equal(TD.df_neg(*xt[:2]), JD.df_neg(*xj[:2]))


def test_df64_reductions_bits():
    rng = np.random.default_rng(1)
    n = 1 << 12
    # adversarial: large cancellation (plain f32 loses ~all digits)
    x = np.concatenate([_f32(rng, n // 2, 1e4), -_f32(rng, n // 2, 1e4)])
    y = _f32(rng, n)
    lo = _f32(rng, n, 1e-8)
    _bits_equal(TD.df64_dot(_t(x), _t(y)),
                JD.df64_dot(jnp.asarray(x), jnp.asarray(y)))
    _bits_equal(TD.df64_norm2(_t(y)), JD.df64_norm2(jnp.asarray(y)))
    _bits_equal(TD.df64_sum(_t(x[:1001])), JD.df64_sum(jnp.asarray(x[:1001])))
    _bits_equal(TD.df64_sum(_t(x), _t(lo)),
                JD.df64_sum(jnp.asarray(x), jnp.asarray(lo)))
    _bits_equal(TD.df64_dot_df(_t(x), _t(lo), _t(y), _t(lo)),
                JD.df64_dot_df(*(jnp.asarray(v) for v in (x, lo, y, lo))))
    h, l_ = TD.df64_dot(_t(x), _t(y))
    exact = float(x.astype(np.float64) @ y.astype(np.float64))
    got = float(h.double() + l_.double())
    assert abs(got - exact) / float(np.abs(x).sum()) < 1e-13


def test_df64_dot_dist_bits_and_f64():
    """The distributed compensated dot over 8 parts: bit for bit the
    reference's over its 8-device mesh, fp64-accurate, and no worse than
    the plain f32 dot."""
    from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec
    from ginkgo_tpu_torch.distributed import make_mesh
    rng = np.random.default_rng(7)
    n = 4096
    x, y = _f32(rng, n), _f32(rng, n)
    jmesh = JMesh(np.array(jax.devices()[:8]), ("rows",))
    sh = NamedSharding(jmesh, PartitionSpec("rows"))
    hj, lj = JD.df64_dot_dist(jax.device_put(jnp.asarray(x), sh),
                              jax.device_put(jnp.asarray(y), sh), jmesh)
    h, l_ = TD.df64_dot_dist(_t(x), _t(y), make_mesh((8,), ("rows",),
                                                     device="cpu"))
    _bits_equal((h, l_), (hj, lj))
    got = float(h.double() + l_.double())
    want = float(x.astype(np.float64) @ y.astype(np.float64))
    assert abs(got - want) / (abs(want) + 1) < 1e-10
    naive = float(_t(x) @ _t(y))
    assert abs(got - want) <= abs(naive - want) + 1e-12


def _band(rng, n, offsets):
    dv = np.zeros((len(offsets), n), np.float32)
    for d, k in enumerate(offsets):
        lo, hi = max(0, -k), min(n, n - k)
        dv[d, lo:hi] = _f32(rng, hi - lo, 2.0)
    return dv


def test_dia_and_csr_spmv_df64_bits():
    rng = np.random.default_rng(3)
    n = 5000
    offsets = (-64, -1, 0, 1, 64)
    dv = _band(rng, n, offsets)
    xh = _f32(rng, n)
    xl = _f32(rng, n, 1e-8)
    got = TD.dia_spmv_df64(offsets, _t(dv), n, _t(xh), _t(xl))
    _bits_equal(got, JD.dia_spmv_df64(offsets, jnp.asarray(dv), n,
                                      jnp.asarray(xh), jnp.asarray(xl)))
    # the COO form of the same matrix, padded with rows == n
    rows, cols, vals = [], [], []
    for d, k in enumerate(offsets):
        i = np.arange(max(0, -k), min(n, n - k))
        rows.append(i)
        cols.append(i + k)
        vals.append(dv[d, i])
    order = np.lexsort((np.concatenate(cols), np.concatenate(rows)))
    r = np.concatenate(rows)[order]
    c = np.concatenate(cols)[order]
    v = np.concatenate(vals)[order]
    r = np.concatenate([r, np.full(3, n)]).astype(np.int32)
    c = np.concatenate([c, np.zeros(3, np.int64)]).astype(np.int32)
    v = np.concatenate([v, np.zeros(3, np.float32)])
    got = TD.csr_spmv_df64(_t(r), _t(c), _t(v), n, _t(xh), _t(xl))
    _bits_equal(got, JD.csr_spmv_df64(*(jnp.asarray(a) for a in (r, c, v)),
                                      n, jnp.asarray(xh), jnp.asarray(xl)))
    A = sp.csr_matrix((v[:-3].astype(np.float64), (r[:-3], c[:-3])),
                      shape=(n, n))
    exact = A @ (xh.astype(np.float64) + xl.astype(np.float64))
    yh, yl = TD.dia_spmv_df64(offsets, _t(dv), n, _t(xh), _t(xl))
    full = yh.double().numpy() + yl.double().numpy()
    scale = np.abs(A).max() * np.abs(xh).max() * len(offsets)
    assert np.abs(full - exact).max() / scale < 1e-13


def _fem_pattern():
    """``test_pell_spmv_df64_matches_f64_on_fem_pattern``'s matrix."""
    rng = np.random.default_rng(3)
    n, n_off, spread = 1024, 24, 500
    offs = rng.integers(-spread, spread, (-(-n // 128), n_off))
    pick = rng.random((n, n_off)) < 0.6
    r = np.repeat(np.arange(n), n_off).reshape(n, n_off)
    c = np.clip(r + offs[np.arange(n) // 128], 0, n - 1)
    key = np.unique(r[pick] * n + c[pick])
    return (n, (key // n).astype(np.int64), (key % n).astype(np.int64),
            rng.standard_normal(key.size), rng)


def test_pell_spmv_df64_bits():
    n, rows, cols, vals, rng = _fem_pattern()
    At = gtt.Csr.from_data(gtt.MatrixData((n, n), rows, cols, vals),
                           dtype=np.float32, strategy="packed", device="cpu")
    Aj = gt.Csr.from_data(gt.MatrixData((n, n), rows, cols, vals),
                          dtype=np.float32, strategy="packed")
    assert At.strategy == Aj.strategy == "packed"
    x64 = rng.standard_normal(n)
    xh = x64.astype(np.float32)
    xl = (x64 - xh.astype(np.float64)).astype(np.float32)
    got = TD._apply_df64(At, _t(xh), _t(xl))
    want = JD._apply_df64(Aj, jnp.asarray(xh), jnp.asarray(xl))
    _bits_equal(got, want)
    _bits_equal(TD.pell_spmv_df64(At.pell_vals, At.pell_idx, At.pell_qw,
                                  At.pell_xbase, At.pell_meta, _t(xh),
                                  _t(xl)),
                JD.pell_spmv_df64(Aj.pell_vals, Aj.pell_idx, Aj.pell_qw,
                                  Aj.pell_xbase, Aj.pell_meta,
                                  jnp.asarray(xh), jnp.asarray(xl)))
    dense = np.zeros((n, n))
    dense[rows, cols] = vals.astype(np.float32)
    oracle = dense @ x64
    full = got[0].double().numpy() + got[1].double().numpy()
    assert np.abs(full - oracle).max() / (np.abs(oracle).max() + 1) < 1e-12


def _stencil16():
    data = stencil_3d(16, points=7)
    return (data, gtt.Csr.from_data(data, dtype=np.float32, device="cpu"),
            gt.Csr.from_data(_jd(data), dtype=np.float32))


def test_ir_df64_history():
    """``ir_df64`` on ``stencil_3d(16, points=7)``, b = ones, 4 sweeps,
    with an inner solve that is one f32 multiply (d = r / 6): x and the
    history at 1e-12 relative to the reference's.  (An inner f32 solve
    with sums, such as CG, orders them differently in the two packages,
    and its rounding then sets the later sweeps' norms.)"""
    _, At, Aj = _stencil16()
    n = At.shape[0]
    (xh, xl), hist = TD.ir_df64(At, torch.ones(n),
                                lambda A, r: r * (1 / 6), iterations=4)
    (jh, jl), hist_j = JD.ir_df64(Aj, jnp.ones(n, jnp.float32),
                                  lambda A, r: r * (1 / 6), iterations=4)
    assert hist.dtype == torch.float32 and hist.shape == (4,)
    np.testing.assert_allclose(hist.numpy(), np.asarray(hist_j), rtol=1e-12)
    x = xh.double().numpy() + xl.double().numpy()
    xj = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    np.testing.assert_allclose(x, xj, rtol=1e-12, atol=1e-12 * np.abs(
        xj).max())


def test_ir_df64_reaches_fp64_residual():
    """f32 CG to 1e-6 + df64-residual IR (``test_df64.py``'s ``_cg_inner``),
    4 sweeps: the true residual under ``test_df64.py``'s 5e-11, as the
    reference's; the first sweep's norm (of b) equal."""
    data, At, Aj = _stencil16()
    n = At.shape[0]

    def inner_t(A, r):
        return Cg.solve(A, r, criteria=[Iteration(200),
                                        ResidualNorm(1e-6)]).x.reshape(-1)

    def inner_j(A, r):
        return jcg.solve(A, r, criteria=[JIteration(200),
                                         JResidualNorm(1e-6)]).x.reshape(-1)

    (xh, xl), hist = TD.ir_df64(At, torch.ones(n), inner_t, iterations=4)
    (jh, jl), hist_j = JD.ir_df64(Aj, jnp.ones(n, jnp.float32), inner_j,
                                  iterations=4)
    assert hist[0] == float(hist_j[0]) == 64.0
    d = data.canonical()
    S = sp.csr_matrix((d.values, (d.row_idx, d.col_idx)), shape=(n, n))

    def rel(x64):
        return np.linalg.norm(np.ones(n) - S @ x64) / np.sqrt(n)

    got = rel(xh.double().numpy() + xl.double().numpy())
    want = rel(np.asarray(jh, np.float64) + np.asarray(jl, np.float64))
    assert got < 5e-11 and want < 5e-11, (got, want)
    # a plain f32 solve cannot reach that floor
    assert got < 1e-3 * rel(inner_t(At, torch.ones(n)).double().numpy())


# -- dc64 ---------------------------------------------------------------------

def _complex_band():
    """``test_dc64_complex_double_tier``'s 1024-row complex band."""
    rng = np.random.default_rng(0)
    n = 1024
    offsets = (-32, -1, 0, 1, 32)
    dv = (rng.standard_normal((5, n)) * 0.2
          + 1j * rng.standard_normal((5, n)) * 0.1)
    dv[2] = 4.0 + 0.5j
    dv_re = dv.real.astype(np.float32)
    dv_im = dv.imag.astype(np.float32)
    Af = np.zeros((n, n), np.complex128)
    for d, k in enumerate(offsets):
        i = np.arange(max(0, -k), min(n, n - k))
        Af[i, i + k] = (dv_re[d, i].astype(np.float64)
                        + 1j * dv_im[d, i].astype(np.float64))
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return n, offsets, dv_re, dv_im, Af, x_true


def test_dc64_operations_bits():
    n, offsets, dv_re, dv_im, Af, x_true = _complex_band()
    xt, xj = TC.dc_from_c64(x_true, device="cpu"), JC.dc_from_c64(x_true)
    _bits_equal(xt, xj)
    b = Af @ x_true
    bt, bj = TC.dc_from_c64(torch.from_numpy(b)), JC.dc_from_c64(b)
    _bits_equal(bt, bj)
    np.testing.assert_array_equal(TC.dc_to_c128(xt), JC.dc_to_c128(xj))
    _bits_equal(TC.dc_add(xt, bt), JC.dc_add(xj, bj))
    _bits_equal(TC.dc_neg(xt), JC.dc_neg(xj))
    _bits_equal(TC.dc_mul(xt, bt), JC.dc_mul(xj, bj))
    _bits_equal(TC.dc64_dot(xt, bt), JC.dc64_dot(xj, bj))
    _bits_equal(TC.dc64_norm2(bt), JC.dc64_norm2(bj))
    y = TC.dia_spmv_dc64(offsets, _t(dv_re), _t(dv_im), n, xt)
    _bits_equal(y, JC.dia_spmv_dc64(offsets, jnp.asarray(dv_re),
                                    jnp.asarray(dv_im), n, xj))
    oracle = Af @ TC.dc_to_c128(xt)
    assert (np.abs(TC.dc_to_c128(y) - oracle).max()
            / np.abs(oracle).max()) < 1e-13


def test_ir_dc64_history():
    """``ir_dc64`` on the complex band with an inner solve of one f32
    multiply a plane (d = r / 4, a Richardson step): x and the history
    at 1e-12 relative to the reference's over 5 sweeps."""
    n, offsets, dv_re, dv_im, Af, x_true = _complex_band()
    b = Af @ x_true
    x, hist = TC.ir_dc64(offsets, _t(dv_re), _t(dv_im), n,
                         TC.dc_from_c64(b, device="cpu"),
                         lambda re, im: (re * 0.25, im * 0.25), iterations=5)
    xj, hist_j = JC.ir_dc64(offsets, jnp.asarray(dv_re), jnp.asarray(dv_im),
                            n, JC.dc_from_c64(b),
                            lambda re, im: (re * 0.25, im * 0.25),
                            iterations=5)
    assert hist.shape == (5,) and hist.dtype == torch.float32
    np.testing.assert_allclose(hist.numpy(), np.asarray(hist_j), rtol=1e-12)
    want = JC.dc_to_c128(xj)
    np.testing.assert_allclose(TC.dc_to_c128(x), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    assert hist[-1] < 1e-2 * hist[0]


def test_ir_dc64_reaches_complex_double_residual():
    """``ir_dc64`` with the reference test's inner solve (40 diagonally
    preconditioned Richardson steps in f32) on the 1024-row complex band:
    the complex128 true residual under ``test_complex_sweep.py``'s 1e-11,
    as the reference's, and the first sweep's norm (of b) at 1e-12.  (XLA
    contracts the inner loop's multiply-adds into FMAs, so the later
    sweeps' norms differ in their f32 rounding.)"""
    n, offsets, dv_re, dv_im, Af, x_true = _complex_band()
    b = Af @ x_true
    den = (dv_re[2].astype(np.float64) ** 2
           + dv_im[2].astype(np.float64) ** 2)
    inv_re = (dv_re[2] / den).astype(np.float32)
    inv_im = (-dv_im[2] / den).astype(np.float32)

    def sweep(dvr, dvi, ir, ii, shift, zeros, r_re, r_im, xr, xi):
        yr = zeros(n)
        yi = zeros(n)
        for d, k in enumerate(offsets):
            sr, si = shift(xr, k), shift(xi, k)
            yr = yr + dvr[d] * sr - dvi[d] * si
            yi = yi + dvr[d] * si + dvi[d] * sr
        rr, ri = r_re - yr, r_im - yi
        return xr + rr * ir - ri * ii, xi + rr * ii + ri * ir

    planes_t = (_t(dv_re), _t(dv_im), _t(inv_re), _t(inv_im))

    def inner_t(r_re, r_im):
        dvr, dvi, ir, ii = planes_t
        xr, xi = r_re * ir - r_im * ii, r_re * ii + r_im * ir
        for _ in range(40):
            xr, xi = sweep(*planes_t, TD._shift, torch.zeros, r_re, r_im,
                           xr, xi)
        return xr, xi

    planes_j = tuple(jnp.asarray(a) for a in (dv_re, dv_im, inv_re, inv_im))

    def jshift(x, k):
        return jnp.pad(x[k:], (0, k)) if k >= 0 else jnp.pad(x[:k], (-k, 0))

    def inner_j(r_re, r_im):
        dvr, dvi, ir, ii = planes_j
        xr, xi = r_re * ir - r_im * ii, r_re * ii + r_im * ir
        # a loop, as the reference test has it (unrolled, XLA compiles
        # for minutes)
        return jax.lax.fori_loop(0, 40, lambda _, c: sweep(
            *planes_j, jshift, lambda m: jnp.zeros(m, jnp.float32), r_re,
            r_im, *c), (xr, xi))

    x, hist = TC.ir_dc64(offsets, _t(dv_re), _t(dv_im), n,
                         TC.dc_from_c64(b, device="cpu"), inner_t,
                         iterations=5)
    xj, hist_j = JC.ir_dc64(offsets, jnp.asarray(dv_re),
                            jnp.asarray(dv_im), n, JC.dc_from_c64(b),
                            inner_j, iterations=5)
    assert hist.shape == (5,)
    np.testing.assert_allclose(hist.numpy()[0], np.asarray(hist_j)[0],
                               rtol=1e-12)
    for got in (x, xj):
        r = b - Af @ TC.dc_to_c128(got)
        rel = np.linalg.norm(r) / np.linalg.norm(b)
        assert rel < 1e-11, rel
