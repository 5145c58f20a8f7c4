"""Triangular solves: the port against ginkgo_tpu on the same factors.

The host planners (level sets, the banded block plan, the packed plan)
must give identical arrays; the solves of every algorithm must agree to
rtol 1e-10 in f64 (sums in another order, nothing else differs) and to
1e-5 of max |x| for the f32 packed exact solve (f32 block products).
Inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.ops import tri_banded as jtb
from ginkgo_tpu.ops import tri_packed as jtp
from ginkgo_tpu.solver import triangular as jtri
from ginkgo_tpu_torch.ops import tri_banded, tri_inv, tri_packed
from ginkgo_tpu_torch.ops.tri_inv import batched_lowtri_inverse
from ginkgo_tpu_torch.solver import triangular
from ginkgo_tpu_torch.utils import generators as tgen

CPU = torch.device("cpu")


class _Holder:
    """A factor as both packages' generate() reads it: host MatrixData on
    the CPU."""

    def __init__(self, data):
        self._d = data
        self.device = CPU

    def to_matrix_data(self):
        return self._d


def _jdata(d):
    return gt.MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


# the unstructured lower factors of tests/test_triangular_ilu.py
random_lower = tgen.random_lower_factor


def banded_lower(dtype=np.float64):
    """Lower triangle of the 27-point stencil at nx=8 (13 offsets + the
    diagonal): a banded factor."""
    d = tgen.stencil_3d(8, points=27, dtype=dtype)
    keep = d.col_idx <= d.row_idx
    return gtt.MatrixData(d.shape, d.row_idx[keep], d.col_idx[keep],
                          d.values[keep]).canonical()


def transposed(d):
    return gtt.MatrixData(d.shape, d.col_idx.copy(), d.row_idx.copy(),
                          d.values.copy()).canonical()


def factor(kind, lower, dtype):
    d = (banded_lower(dtype) if kind == "banded"
         else random_lower(1500, 7, 500, 5, dtype=dtype))
    return d if lower else transposed(d)


def _rhs(n, k, dtype, seed=3):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(dtype)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- planners ---------------------------------------------------------------
@pytest.mark.parametrize("kind", ["banded", "unstructured"])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
def test_levels_and_level_schedule_identical(kind, lower):
    d = factor(kind, lower, np.float64)
    n = d.shape[0]
    lv = triangular.compute_levels(n, d.row_idx, d.col_idx, lower)
    jlv = jtri.compute_levels(n, d.row_idx, d.col_idx, lower)
    assert np.array_equal(lv, jlv) and lv.max() > 5
    diag = np.ones(n)
    got = triangular._pack_levels(n, d.row_idx, d.col_idx, d.values, diag,
                                  lv)
    want = jtri._pack_levels(n, d.row_idx, d.col_idx, d.values, diag, jlv)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
@pytest.mark.parametrize("unit", [False, True], ids=["diag", "unit"])
def test_block_plan_identical(lower, unit):
    d = factor("banded", lower, np.float64)
    got = tri_banded.plan_block_trisolve(d, lower, unit)
    want = jtb.plan_block_trisolve(_jdata(d), lower, unit)
    assert got is not None and want is not None
    (ga, gm), (wa, wm) = got, want
    assert gm == wm
    for name in ("inv", "ov"):
        assert np.array_equal(_np(ga[name]), _np(wa[name])), name
    # too many offsets for the banded plan, like the reference
    du = factor("unstructured", lower, np.float64)
    assert tri_banded.plan_block_trisolve(du, lower, unit) is None
    assert jtb.plan_block_trisolve(_jdata(du), lower, unit) is None


def test_device_inverse_build_matches_host_build():
    """The build that the card takes for f32 factors (scatter + doubling
    inverse), forced here on the host, against the LAPACK host build."""
    d = banded_lower(np.float32)
    (dev, _), (host, _) = (tri_banded.plan_block_trisolve(
        d, True, False, device_build=flag) for flag in (True, False))
    np.testing.assert_allclose(_np(dev["inv"]), _np(host["inv"]),
                               rtol=1e-5, atol=1e-6)
    assert not tri_banded._want_device_inverse(np.float32, "cpu")
    assert tri_banded._want_device_inverse(np.float32, "cuda")
    assert not tri_banded._want_device_inverse(np.float64, "cuda")


@pytest.mark.parametrize("case", [(1500, 7, 500, 5, True, False),
                                  (1700, 7, 600, 7, False, False),
                                  (1200, 5, 400, 9, True, True)],
                         ids=["lower", "upper-odd-nb", "lower-unit"])
def test_packed_plan_identical(case):
    n, per, reach, seed, lower, unit = case
    d = random_lower(n, per, reach, seed)
    d = d if lower else transposed(d)
    tri_packed._SYM_CACHE.clear()
    arrays, meta = tri_packed.plan_packed_trisolve(d, lower, unit)
    jarrays, jmeta = jtp.plan_packed_trisolve(_jdata(d), lower, unit)
    assert meta == jmeta and dict(meta)["nb"] == -(-n // 256)
    for name in ("crossi", "crossv", "nwv"):
        assert np.array_equal(_np(arrays[name]), _np(jarrays[name])), name
    inv, jinv = _np(arrays["inv"]), _np(jarrays["inv"])
    np.testing.assert_allclose(inv, jinv, rtol=1e-5,
                               atol=1e-5 * np.abs(jinv).max())
    # exactly lower triangular: the CUDA kernel skips the upper part
    assert not np.triu(inv, 1).any()


def test_packed_plan_budget_and_dtype_guards(monkeypatch):
    """The rejects of tests/test_triangular_ilu.py:495-534: a complex
    factor with a cached f32 pattern misses the f32 slot and rejects; a
    tiny budget rejects; the cache key also holds the device."""
    d = random_lower(1200, 5, 400, 9, scale=0.04)
    tri_packed._SYM_CACHE.clear()
    assert tri_packed.plan_packed_trisolve(d, True, False) is not None
    dc = gtt.MatrixData(d.shape, d.row_idx.copy(), d.col_idx.copy(),
                        d.values.astype(np.complex64)).canonical()
    assert tri_packed.plan_packed_trisolve(dc, True, False) is None
    assert tri_packed.plan_packed_trisolve(d, True, False) is not None
    keys = [key for key in tri_packed._SYM_CACHE._slots]
    assert all(key[-1] == "cpu" for key in keys)

    tri_packed._SYM_CACHE.clear()
    monkeypatch.setattr(tri_packed, "_MAX_PLAN_BYTES", 1 << 20)
    assert tri_packed.plan_packed_trisolve(d, True, False) is None
    # too small for one block pair, and wrong-side factors reject as in
    # the reference
    assert tri_packed.plan_packed_trisolve(
        random_lower(400, 3, 100, 1), True, False) is None
    assert tri_packed.plan_packed_trisolve(transposed(d), True,
                                           False) is None


def test_inverse_build_turns_tf32_off_and_restores_the_flag(monkeypatch):
    """The doubling products run with cuBLAS TF32 off whatever the
    caller set, and the caller's setting is back afterwards, also when
    the build raises."""
    flags = torch.backends.cuda.matmul
    prev = flags.fp32_precision
    seen = []

    def record(Lb, unit_diagonal):
        seen.append(flags.fp32_precision)
        if unit_diagonal:
            raise RuntimeError("build failed")
        return Lb

    monkeypatch.setattr(tri_inv, "_doubling_inverse", record)
    try:
        flags.fp32_precision = "tf32"
        batched_lowtri_inverse(torch.eye(4)[None])
        assert flags.fp32_precision == "tf32"
        with pytest.raises(RuntimeError, match="build failed"):
            batched_lowtri_inverse(torch.eye(4)[None], unit_diagonal=True)
        assert flags.fp32_precision == "tf32"
    finally:
        flags.fp32_precision = prev
    assert seen == ["ieee", "ieee"]


def test_batched_lowtri_inverse_against_numpy():
    rng = np.random.default_rng(4)
    Lb = np.tril(rng.standard_normal((3, 64, 64)) * 0.1)
    Lb[:, np.arange(64), np.arange(64)] = 1.5 + rng.random((3, 64))
    Lb[1, 5, 5] = 0.0                       # a zero pivot inverts as 1
    got = batched_lowtri_inverse(torch.from_numpy(Lb)).numpy()
    fixed = Lb.copy()
    fixed[1, 5, 5] = 1.0
    np.testing.assert_allclose(got, np.linalg.inv(fixed), rtol=1e-12,
                               atol=1e-12)
    unit = batched_lowtri_inverse(torch.from_numpy(Lb),
                                  unit_diagonal=True).numpy()
    ones = Lb.copy()
    ones[:, np.arange(64), np.arange(64)] = 1.0
    np.testing.assert_allclose(unit, np.linalg.inv(ones), rtol=1e-12,
                               atol=1e-12)


# -- solves -----------------------------------------------------------------
SOLVES = [
    # (factor kind, dtype, algorithm, expected algorithm after generate)
    ("banded", np.float64, "auto", "exact"),
    ("banded", np.float64, "exact", "exact"),
    ("banded", np.float64, "level", "level"),
    ("banded", np.float64, "jacobi", "jacobi"),
    ("unstructured", np.float64, "auto", "level"),
    ("unstructured", np.float64, "jacobi", "jacobi"),
    ("unstructured", np.float32, "auto", "exact_packed"),
    ("unstructured", np.float32, "exact", "exact_packed"),
    ("banded", np.float32, "auto", "exact"),
]


@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
@pytest.mark.parametrize("kind,dtype,algo,expect", SOLVES,
                         ids=[f"{k}-{np.dtype(t).name}-{a}"
                              for k, t, a, _ in SOLVES])
def test_trisolve_matches_jax(kind, dtype, algo, expect, lower):
    d = factor(kind, lower, dtype)
    api, japi = ((triangular.LowerTrs, jtri.LowerTrs) if lower
                 else (triangular.UpperTrs, jtri.UpperTrs))
    op = api.build(algorithm=algo).generate(_Holder(d))
    jop = japi.build(algorithm=algo).generate(_Holder(_jdata(d)))
    assert op.algorithm == jop.algorithm == expect
    assert op.num_levels == jop.num_levels
    b = _rhs(d.shape[0], 3, dtype)
    x = op._apply(torch.from_numpy(b)).numpy()
    xj = np.asarray(jop._apply(jnp.asarray(b)))
    assert x.dtype == xj.dtype == dtype
    if dtype == np.float64:
        np.testing.assert_allclose(x, xj, rtol=1e-10,
                                   atol=1e-10 * np.abs(xj).max())
    else:
        assert np.abs(x - xj).max() <= 1e-5 * np.abs(xj).max()


def test_exact_request_on_unplannable_factor_raises():
    d = factor("unstructured", True, np.float64)
    with pytest.raises(ValueError, match="algorithm='exact'"):
        triangular.LowerTrs.build(algorithm="exact").generate(_Holder(d))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("bdtype", [np.float32, np.float64])
def test_packed_plain_version_matches_jax_reference(bdtype, k):
    """The port's plain kernel-C version on the JAX package's own plan
    against ``packed_trisolve_reference`` (f64 right-hand sides are solved
    in f32 by both)."""
    for lower in (True, False):
        d = random_lower(1700, 7, 600, 7, scale=0.04)
        d = d if lower else transposed(d)
        jarrays, meta = jtp.plan_packed_trisolve(_jdata(d), lower, False)
        arrays = {name: torch.from_numpy(np.array(a))
                  for name, a in jarrays.items()}
        b = _rhs(d.shape[0], k, bdtype, seed=11)
        x = tri_packed.packed_trisolve_reference(arrays, meta,
                                                 torch.from_numpy(b))
        xj = np.asarray(jtp.packed_trisolve_reference(jarrays, meta,
                                                      jnp.asarray(b)))
        assert x.dtype == torch.from_numpy(xj).dtype
        assert np.abs(x.numpy() - xj).max() <= 1e-5 * np.abs(xj).max()
        # the wrapper takes the plain version for host tensors
        xw = tri_packed.packed_trisolve_cuda(arrays, meta,
                                             torch.from_numpy(b))
        assert torch.equal(xw, x)


def test_packed_plain_version_matches_pallas_interpret():
    """Against the Pallas kernel itself, run in interpret mode."""
    d = random_lower(600, 5, 300, 13, scale=0.04)
    jarrays, meta = jtp.plan_packed_trisolve(_jdata(d), True, False)
    arrays = {name: torch.from_numpy(np.array(a))
              for name, a in jarrays.items()}
    b = _rhs(600, 2, np.float32, seed=12)
    x = tri_packed.packed_trisolve_reference(arrays, meta,
                                             torch.from_numpy(b)).numpy()
    xj = np.asarray(jtp.packed_trisolve_tpu(jarrays, meta, jnp.asarray(b),
                                            interpret=True))
    assert np.abs(x - xj).max() <= 1e-5 * np.abs(xj).max()
