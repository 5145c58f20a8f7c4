"""Sparse products and sums (``ops/spgemm.py``): the port against
ginkgo_tpu on the same seeded inputs, in f64 (and complex128) on the CPU.
Every result must have the reference's pattern, entry for entry, and its
values to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.ops import spgemm as js
from ginkgo_tpu_torch import native
from ginkgo_tpu_torch.ops import spgemm as ts
from ginkgo_tpu_torch.utils import generators as tgen

CPU = torch.device("cpu")


def _j(d):
    return gt.MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


def _same(got, want, rtol=1e-12):
    got, want = got.canonical(), want.canonical()
    assert got.shape == tuple(want.shape)
    assert np.array_equal(got.row_idx, want.row_idx)
    assert np.array_equal(got.col_idx, want.col_idx)
    np.testing.assert_allclose(got.values, want.values, rtol=rtol,
                               atol=rtol * max(np.abs(want.values).max(), 1))


def _pair(seed, n=60, k=45, m=70, cpx=False):
    a = tgen.generate_random_matrix(n, k, nonzeros_per_row=(1, 8), seed=seed)
    b = tgen.generate_random_matrix(k, m, nonzeros_per_row=(1, 8),
                                    seed=seed + 1)
    if cpx:
        a = gtt.MatrixData(a.shape, a.row_idx, a.col_idx,
                           a.values * (1 + 0.5j))
    return a, b


@pytest.mark.parametrize("numeric", ["host", "device", "scipy"])
@pytest.mark.parametrize("cpx", [False, True], ids=["f64", "c128"])
def test_spgemm_data_numeric_paths_match_jax(numeric, cpx):
    a, b = _pair(21, cpx=cpx)
    c = ts.spgemm_data(a, b, numeric=numeric, device="cpu")
    _same(c, js.spgemm_data(_j(a), _j(b), numeric=numeric))
    np.testing.assert_allclose(c.to_dense(), a.to_dense() @ b.to_dense(),
                               rtol=1e-12, atol=1e-13)


def test_spgemm_without_native_takes_scipy(monkeypatch):
    a, b = _pair(31)
    want = ts.spgemm_data(a, b, numeric="host", device="cpu")
    monkeypatch.setattr(native, "lib", lambda: None)
    _same(ts.spgemm_data(a, b, numeric="host", device="cpu"), want)
    _same(ts.spgemm_data(a, b, numeric="device", device="cpu"), want)


def test_spgemm_route_by_device_and_size():
    small = tgen.stencil_2d(8)
    big = tgen.stencil_3d(32, points=7)            # 223,232 entries
    wide = tgen.stencil_3d(30, points=27)          # > 16M pairs squared
    assert ts.spgemm_route(big, big, "cpu") == "host"
    assert ts.spgemm_route(big, big, "cuda") == "device"
    assert ts.spgemm_route(small, small, "cuda") == "host"
    assert ts.spgemm_flops(wide, wide) > ts._STREAM_FLOPS
    assert ts.spgemm_route(wide, wide, "cuda") == "host"
    assert ts.spgemm_flops(big, big) == js.spgemm_flops(_j(big), _j(big))


def test_spgemm_auto_on_cpu_is_the_host_product():
    d = tgen.stencil_3d(6, points=27)
    _same(ts.spgemm_data(d, d, device="cpu"),
          js.spgemm_data(_j(d), _j(d), numeric="host"))
    with pytest.raises(ValueError, match="spgemm dims"):
        ts.spgemm_data(*_pair(3, k=5)[::-1], device="cpu")


@pytest.mark.parametrize("alpha,beta", [(2.0, -0.5), (1.0, 1.0)])
def test_spgeam_and_advanced_spgemm_match_jax(alpha, beta):
    a = tgen.generate_random_matrix(20, 20, nonzeros_per_row=(1, 5), seed=9)
    b = tgen.generate_random_matrix(20, 20, nonzeros_per_row=(1, 5),
                                    seed=10)
    _same(ts.spgeam_data(alpha, a, beta, b),
          js.spgeam_data(alpha, _j(a), beta, _j(b)))
    x, y = _pair(30, n=12, k=10, m=14)
    z = tgen.generate_random_matrix(12, 14, nonzeros_per_row=(1, 3),
                                    seed=32)
    got = ts.advanced_spgemm_data(alpha, x, y, beta, z, device="cpu")
    assert got.shape == (12, 14)
    _same(got, js.advanced_spgemm_data(alpha, _j(x), _j(y), beta, _j(z)))


def test_spgemm_reuse_numeric_matches_jax():
    a = tgen.generate_random_matrix(18, 12, nonzeros_per_row=(1, 4),
                                    seed=11)
    b = tgen.generate_random_matrix(12, 16, nonzeros_per_row=(1, 4),
                                    seed=12)
    reuse = ts.SpgemmReuse(a, b, device="cpu")
    jreuse = js.SpgemmReuse(_j(a), _j(b))
    np.testing.assert_array_equal(reuse.out_rows, jreuse.out_rows)
    np.testing.assert_array_equal(reuse.out_cols, jreuse.out_cols)
    av = a.canonical().values
    bv = b.canonical().values
    for scale in (1.0, 3.0):
        cv = reuse.numeric(torch.from_numpy(av * scale),
                           torch.from_numpy(bv))
        assert cv.device == CPU
        jcv = jreuse.numeric(jnp.asarray(av * scale), jnp.asarray(bv))
        np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), rtol=1e-12)
    c = reuse.to_matrix_data(cv)
    np.testing.assert_allclose(c.to_dense(),
                               3.0 * a.to_dense() @ b.to_dense(),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_csr_spgemm_spgeam_keep_device_and_type(dtype):
    d = tgen.stencil_2d(7)
    A = gtt.Csr.from_data(d, dtype=dtype, device="cpu")
    Aj = gt.Csr.from_data(_j(d), dtype=dtype)
    C, Cj = A.spgemm(A), Aj.spgemm(Aj)
    assert C.device == CPU
    assert C.dtype == (torch.float64 if dtype == np.float64
                       else torch.float32)
    _same(C.to_matrix_data(), Cj.to_matrix_data(), rtol=1e-6
          if dtype == np.float32 else 1e-12)
    S, Sj = A.spgeam(1.5, -1.0, C), Aj.spgeam(1.5, -1.0, Cj)
    assert S.device == CPU and S.strategy == Sj.strategy
    _same(S.to_matrix_data(), Sj.to_matrix_data(), rtol=1e-6
          if dtype == np.float32 else 1e-12)
