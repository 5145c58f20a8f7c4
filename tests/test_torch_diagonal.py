"""``Diagonal``: the port against ginkgo_tpu on the same inputs, in f64 and
complex128 on the CPU — every method of the reference's class, the
diagonals other classes hand out (``Coo``/``Csr``/``Dense``
``extract_diagonal``) and ``from_data``'s device rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.matrix.diagonal import Diagonal as JDiagonal
from ginkgo_tpu_torch.matrix.diagonal import Diagonal

DTYPES = [np.float64, np.complex128]


def _values(dtype, n=7, seed=3):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(n)
    v[2] = -abs(v[2])
    return v.astype(dtype)


def _pair(dtype):
    v = _values(dtype)
    return Diagonal(torch.from_numpy(v)), JDiagonal(values=jnp.asarray(v))


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-15, atol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "c128"])
def test_rapply_scales_columns(dtype):
    D, Dj = _pair(dtype)
    b = np.random.default_rng(4).standard_normal((3, 7)).astype(dtype)
    _close(D.rapply(torch.from_numpy(b)), Dj.rapply(jnp.asarray(b)))
    _close(D.rapply(torch.from_numpy(b)), b * D.values.numpy()[None, :])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "c128"])
def test_absolute_and_transposes(dtype):
    D, Dj = _pair(dtype)
    _close(D.compute_absolute().values, Dj.compute_absolute().values)
    assert D.compute_absolute().values.dtype == D.values.abs().dtype
    _close(D.conj_transpose().values, Dj.conj_transpose().values)
    assert D.transpose() is D
    _close(D.transpose().to_dense(), Dj.transpose().to_dense())
    _close(D.conj_transpose().to_dense(), Dj.conj_transpose().to_dense())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "c128"])
def test_from_data_is_the_canonical_diagonal(dtype):
    rng = np.random.default_rng(5)
    n = 6
    rows = np.concatenate([np.arange(n), [1, 1, 3, 4]])
    cols = np.concatenate([np.arange(n), [1, 2, 3, 0]])
    vals = rng.standard_normal(rows.size).astype(dtype)
    vals[3] = 0.0                            # an explicit zero on row 3 ...
    vals[-2] = 0.0                           # ... and its duplicate
    d = gtt.MatrixData((n, n + 2), rows, cols, vals)
    D = Diagonal.from_data(d, device="cpu")
    Dj = JDiagonal.from_data(gt.MatrixData(d.shape, rows, cols, vals))
    assert D.values.device.type == "cpu" and D.shape == Dj.shape
    _close(D.values, Dj.values)
    D32 = Diagonal.from_data(d, dtype=np.complex64 if np.dtype(dtype).kind
                             == "c" else np.float32, device="cpu")
    assert D32.values.dtype in (torch.float32, torch.complex64)


def test_from_data_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = gtt.MatrixData.diag(np.ones(3))
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        Diagonal.from_data(d)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "c128"])
def test_extracted_diagonals_have_every_method(dtype):
    rng = np.random.default_rng(6)
    dense = rng.standard_normal((5, 5)).astype(dtype)
    if np.dtype(dtype).kind == "c":
        dense = dense + 1j * rng.standard_normal((5, 5))
    dense[np.abs(dense) < 0.4] = 0
    np.fill_diagonal(dense, np.arange(1, 6) * (1 - 1j if np.dtype(
        dtype).kind == "c" else 1))
    b = rng.standard_normal((2, 5)).astype(dtype)
    Dj = gt.Csr.from_dense(dense).extract_diagonal()
    for src in (gtt.Csr.from_dense(dense, device="cpu"),
                gtt.Coo.from_data(gtt.MatrixData.from_dense(dense),
                                  device="cpu"),
                gtt.Dense(torch.from_numpy(dense))):
        D = src.extract_diagonal()
        _close(D.rapply(torch.from_numpy(b)), Dj.rapply(jnp.asarray(b)))
        _close(D.compute_absolute().values, Dj.compute_absolute().values)
        _close(D.conj_transpose().values, Dj.conj_transpose().values)
        assert D.transpose() is D
