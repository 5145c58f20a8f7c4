"""The port's host planners against ginkgo_tpu's: on the same MatrixData
both packages pick the same SpMV strategy and plan bit-identical layouts
(diagonal offsets, band plan, blocked diagonals, COO tail, packed slots).
The port's generators also rebuild the JAX package's matrices exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.utils import generators as jgen
from ginkgo_tpu_torch.utils import generators as tgen

ARRAYS = ("row_ptr", "col_idx", "values", "row_idx", "diag_values",
          "tail_rows", "tail_cols", "tail_vals", "pell_vals", "pell_idx",
          "pell_qw", "pell_xbase")
STATIC = ("shape", "nnz", "strategy", "diag_offsets", "band_meta",
          "pell_meta")


def _fem_like(n, n_off=24, spread=500, seed=0):
    """The unstructured pattern of tests/test_spmv_packed.py."""
    rng = np.random.default_rng(seed)
    offs = rng.integers(-spread, spread, (-(-n // 128), n_off))
    pick = rng.random((n, n_off)) < 0.6
    r = np.repeat(np.arange(n), n_off).reshape(n, n_off)
    c = np.clip(r + offs[np.arange(n) // 128], 0, n - 1)
    rows, cols = r[pick], c[pick]
    key = np.unique(rows * n + cols)
    rows, cols = (key // n).astype(np.int64), (key % n).astype(np.int64)
    vals = rng.standard_normal(rows.size)
    return rows, cols, vals, (n, n)


def _with_tail(data):
    """A 27-point stencil plus a few far off-band entries (banded + tail)."""
    n = data.shape[0]
    rng = np.random.default_rng(5)
    r = rng.integers(0, n, 20)
    c = (r + n // 2) % n
    return (np.concatenate([data.row_idx, r]),
            np.concatenate([data.col_idx, c]),
            np.concatenate([data.values, rng.standard_normal(20)]),
            data.shape)


def _triplets(name):
    """(rows, cols, vals, shape) of one test matrix, built with numpy."""
    if name == "stencil7":
        d = jgen.stencil_3d(10, points=7)
    elif name == "stencil27":
        d = jgen.stencil_3d(12, points=27)
    elif name == "stencil27_tail":
        return _with_tail(jgen.stencil_3d(10, points=27))
    elif name == "fem_like":
        return _fem_like(2048)
    elif name == "fem_like_spd":
        r, c, v, s = _fem_like(1500, seed=3)
        d = jgen.make_spd(gt.MatrixData(s, r, c, v))
    elif name == "permuted":
        d = jgen.stencil_3d(16, 16, 8, points=27)
        return (*_permute(d.row_idx, d.col_idx, d.shape[0]), d.values,
                d.shape)
    elif name == "random":
        d = jgen.generate_random_matrix(1000, 1000,
                                        nonzeros_per_row=(1, 12), seed=2)
    return d.row_idx, d.col_idx, d.values, d.shape


def _permute(rows, cols, n, run=256, seed=0):
    rng = np.random.default_rng(seed)
    perm = rng.permuted(np.arange(n).reshape(-1, run), axis=1).ravel()
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    return inv[rows], inv[cols]


def jax_arrays(A):
    """A ginkgo_tpu Csr as (arrays, static) numpy/python values."""
    arrays = {k: None if getattr(A, k) is None else np.asarray(getattr(A, k))
              for k in ARRAYS}
    return arrays, {k: getattr(A, k) for k in STATIC}


def torch_arrays(A):
    arrays = {}
    for k in ARRAYS:
        t = getattr(A, k)
        arrays[k] = None if t is None else t.cpu().numpy()
    return arrays, {k: getattr(A, k) for k in STATIC}


EXPECTED = {"stencil7": "banded", "stencil27": "banded",
            "stencil27_tail": "banded", "permuted": "packed"}


@pytest.mark.parametrize("name", ["stencil7", "stencil27", "stencil27_tail",
                                  "fem_like", "fem_like_spd", "permuted",
                                  "random"])
def test_planners_bit_identical(name):
    rows, cols, vals, shape = _triplets(name)
    Aj = gt.Csr.from_data(gt.MatrixData(shape, rows, cols, vals))
    At = gtt.Csr.from_data(gtt.MatrixData(shape, rows, cols, vals),
                           device="cpu")
    (aj, sj), (at, st) = jax_arrays(Aj), torch_arrays(At)
    assert st == sj
    if name in EXPECTED:
        assert st["strategy"] == EXPECTED[name]
    if name == "stencil27_tail":
        assert at["tail_rows"] is not None
    for k in ARRAYS:
        if aj[k] is None:
            assert at[k] is None, k
            continue
        assert at[k].dtype == aj[k].dtype, k
        assert np.array_equal(at[k], aj[k]), k


@pytest.mark.parametrize("points", [7, 27])
def test_generators_match(points):
    dj = jgen.stencil_3d(6, 5, 4, points=points)
    dt = tgen.stencil_3d(6, 5, 4, points=points)
    for k in ("row_idx", "col_idx", "values"):
        assert np.array_equal(getattr(dt, k), getattr(dj, k))
    r, c, v, s = _fem_like(600)
    sj = jgen.make_spd(gt.MatrixData(s, r, c, v))
    st = tgen.make_spd(gtt.MatrixData(s, r, c, v))
    for k in ("row_idx", "col_idx", "values"):
        assert np.array_equal(getattr(st, k), getattr(sj, k))
    gj = jgen.generate_random_matrix(50, 40, nonzeros_per_row=(2, 6), seed=4,
                                     ensure_diag=True)
    gtd = tgen.generate_random_matrix(50, 40, nonzeros_per_row=(2, 6), seed=4,
                                      ensure_diag=True)
    for k in ("row_idx", "col_idx", "values"):
        assert np.array_equal(getattr(gtd, k), getattr(gj, k))


def test_permute_locally_matches_its_definition():
    d = tgen.stencil_3d(16, 16, 8, points=27)
    p = tgen.permute_locally(d, run=256, seed=0)
    r, c = _permute(d.row_idx, d.col_idx, d.shape[0])
    ref = gtt.MatrixData(d.shape, r, c, d.values).canonical()
    for k in ("row_idx", "col_idx", "values"):
        assert np.array_equal(getattr(p, k), getattr(ref, k))
    # still symmetric: P A P^T of a symmetric A
    dense = p.to_dense()
    assert np.array_equal(dense, dense.T)


def test_explicit_strategies_and_bf16():
    d = jgen.stencil_3d(8, points=27)
    for strategy in ("classical", "packed", "merge_path"):
        Aj = gt.Csr.from_data(d, strategy=strategy)
        At = gtt.Csr.from_data(gtt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                              d.values),
                               strategy=strategy, device="cpu")
        assert At.strategy == Aj.strategy
        if At.pell_vals is not None:
            assert np.array_equal(At.pell_idx.numpy(), np.asarray(Aj.pell_idx))
    # bf16 storage: planned in f32 on the host and rounded on upload,
    # as jnp rounds f32 to bf16 (round to nearest even)
    Aj = gt.Csr.from_data(d, dtype=jnp.bfloat16)
    At = gtt.Csr.from_data(gtt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                          d.values),
                           dtype=torch.bfloat16, device="cpu")
    assert At.diag_values.dtype == torch.bfloat16
    assert np.array_equal(At.diag_values.float().numpy(),
                          np.asarray(Aj.diag_values).astype(np.float32))
    with pytest.raises(ValueError, match="unknown CSR strategy"):
        gtt.Csr.from_data(gtt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                         d.values),
                          strategy="nope", device="cpu")
