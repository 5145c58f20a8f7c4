"""The format zoo of the port against ginkgo_tpu's on the same inputs:
``Dense``, ``Coo``, ``Ell``, ``Sellp``, ``Hybrid``, ``Fbcsr``,
``SparsityCsr``, the shared ``SpmvPlan`` and the ``Csr`` methods that
build them, on the CPU.

Three patterns: the 27-point stencil at nx=8 (``banded`` plan), the
``fem`` benchmark case at n=4096 (``packed`` plan) and a random matrix
(no plan: each format's own gather path).  Storage and planned arrays,
and ``to_matrix_data``, must be equal exactly; applies agree to 1e-12
relative to the largest |y| in f64 and 1e-5 in f32 (the two frameworks
sum in another order).  Jacobi-CG on ``Ell`` and BiCGSTAB on ``Hybrid``
take the JAX package's iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.matrix import hybrid as jhybrid
from ginkgo_tpu.preconditioner.jacobi import Jacobi as JJacobi
from ginkgo_tpu.solver import Bicgstab as JBicgstab
from ginkgo_tpu.solver import Cg as JCg
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu_torch.base.matrix_data import MatrixData
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.matrix import hybrid as thybrid
from ginkgo_tpu_torch.matrix.ell import row_positions
from ginkgo_tpu_torch.matrix.fastpath import SpmvPlan, plan_fast_spmv
from ginkgo_tpu_torch.preconditioner import Jacobi
from ginkgo_tpu_torch.solver import Bicgstab, Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils import generators as tgen

CPU = torch.device("cpu")
RTOL = {np.float64: 1e-12, np.float32: 1e-5}
CASES = {
    "banded": (lambda: tgen.stencil_3d(8, points=27), "banded"),
    "packed": (lambda: build_matrix_data({"fem": 4096}), "packed"),
    "classical": (lambda: tgen.generate_random_matrix(
        256, 256, nonzeros_per_row=(1, 30), seed=8, ensure_diag=True), None),
}
# each format's storage tensors, by attribute path
STORAGE = {
    "Coo": ("row_idx", "col_idx", "values"),
    "Ell": ("col_idx", "values", "row_lengths"),
    "Sellp": ("col_flat", "val_flat", "row_flat"),
    "Hybrid": ("ell.col_idx", "ell.values", "ell.row_lengths",
               "coo.row_idx", "coo.col_idx", "coo.values"),
    "Fbcsr": ("block_rows", "block_cols", "blocks"),
}
STATIC = {"Coo": ("shape", "nnz"), "Ell": ("shape", "nnz", "width"),
          "Sellp": ("shape", "nnz", "slice_size", "slice_offsets",
                    "slice_widths", "total_storage"),
          "Hybrid": ("shape", "nnz"),
          "Fbcsr": ("shape", "block_size", "nnzb")}
PLAN_ARRAYS = ("diag_values", "tail_rows", "tail_cols", "tail_vals",
               "pell_vals", "pell_idx", "pell_qw", "pell_xbase")
PLAN_STATIC = ("shape", "strategy", "diag_offsets", "band_meta", "pell_meta")
FORMATS = ("Coo", "Ell", "Sellp", "Hybrid", "Fbcsr")


def jdata(d):
    return gt.MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


def attr(obj, path):
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


def host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() / scale <= rtol, \
        np.abs(got - want).max() / scale


def assert_same_data(dt, dj):
    assert tuple(dt.shape) == tuple(dj.shape)
    for name in ("row_idx", "col_idx", "values"):
        a, b = getattr(dt, name), np.asarray(getattr(dj, name))
        assert np.array_equal(a, b), name


def assert_same_plan(pt, pj):
    assert (pt is None) == (pj is None)
    if pt is None:
        return
    assert isinstance(pt, SpmvPlan)
    for name in PLAN_STATIC:
        assert getattr(pt, name) == getattr(pj, name), name
    for name in PLAN_ARRAYS:
        a, b = getattr(pt, name), getattr(pj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.device == CPU
            assert np.array_equal(host(a), np.asarray(b)), name


def rhs(m, k, seed=1):
    return np.random.default_rng(seed).standard_normal((m, k))


@pytest.mark.parametrize("case,dtype", [
    ("banded", np.float64), ("packed", np.float64), ("classical", np.float64),
    ("packed", np.float32)], ids=["banded-f64", "packed-f64",
                                  "classical-f64", "packed-f32"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_format_matches_jax(fmt, case, dtype):
    make, strategy = CASES[case]
    d = make()
    At = getattr(gtt, fmt).from_data(d, dtype=dtype, device="cpu")
    Aj = getattr(gt, fmt).from_data(jdata(d), dtype=dtype)
    for path in STORAGE[fmt]:
        a, b = attr(At, path), np.asarray(attr(Aj, path))
        assert a.device == CPU and np.array_equal(host(a), b), path
    for name in STATIC[fmt]:
        assert getattr(At, name) == getattr(Aj, name), name
    assert_same_plan(At.fast_op, Aj.fast_op)
    got_strategy = None if At.fast_op is None else At.fast_op.strategy
    assert got_strategy == strategy
    assert_same_data(At.to_matrix_data(), Aj.to_matrix_data())
    np.testing.assert_array_equal(At.to_dense().numpy(),
                                  np.asarray(Aj.to_dense()))
    # the plan's apply and the format's own gather path (fast=False)
    slow_t = getattr(gtt, fmt).from_data(d, dtype=dtype, device="cpu",
                                         fast=False)
    assert slow_t.fast_op is None
    for k in (1, 3):
        b = rhs(d.shape[1], k).astype(dtype)
        yj = np.asarray(Aj.apply(jnp.asarray(b)))
        close(At.apply(torch.from_numpy(b)).numpy(), yj, RTOL[dtype])
        close(slow_t.apply(torch.from_numpy(b)).numpy(), yj, RTOL[dtype])
    # |A| maps every value tensor, the plan's included
    b = rhs(d.shape[1], 2, seed=4).astype(dtype)
    close(At.compute_absolute().apply(torch.from_numpy(b)).numpy(),
          np.asarray(Aj.compute_absolute().apply(jnp.asarray(b))),
          RTOL[dtype])
    close(At.compute_absolute().apply(torch.from_numpy(b)).numpy(),
          np.abs(d.to_dense()) @ b, RTOL[dtype])


@pytest.mark.parametrize("case", sorted(CASES))
def test_row_positions_match_the_loop(case):
    d = CASES[case][0]().canonical()
    ptr = d.row_ptrs()
    loop = np.concatenate([np.arange(n) for n in np.diff(ptr)])
    assert np.array_equal(row_positions(ptr), loop)
    assert np.array_equal(row_positions(np.zeros(5, np.int64)),
                          np.zeros(0, np.int64))


@pytest.mark.parametrize("bs", [2, 3, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fbcsr_blocks_match_add_at(case, bs):
    """On canonical data (no repeated coordinate) the indexed assignment
    of ``Fbcsr.from_data`` places exactly what ``np.add.at`` sums."""
    d = CASES[case][0]().canonical()
    A = gtt.Fbcsr.from_data(d, block_size=bs, device="cpu", fast=False)
    br, bc = d.row_idx // bs, d.col_idx // bs
    keys = br.astype(np.int64) * (-(-d.shape[1] // bs)) + bc
    _, inv = np.unique(keys, return_inverse=True)
    want = np.zeros(tuple(A.blocks.shape), d.values.dtype)
    np.add.at(want, (inv, d.row_idx - br * bs, d.col_idx - bc * bs),
              d.values)
    assert np.array_equal(A.blocks.numpy(), want)


@pytest.mark.parametrize("kw", [dict(), dict(strategy="imbalance_limit",
                                             percent=0.5),
                                dict(strategy="minimal_storage_limit"),
                                dict(strategy="column_limit",
                                     column_limit=4)],
                         ids=["automatic", "imbalance", "minimal",
                              "column_limit"])
def test_hybrid_width_strategies(kw):
    pick = dict(strategy=kw.get("strategy", "automatic"),
                percent=kw.get("percent", 0.8),
                column_limit=kw.get("column_limit"))
    for make, _ in CASES.values():
        lengths = np.diff(make().canonical().row_ptrs())
        w = thybrid._pick_width(lengths, **pick)
        assert w == jhybrid._pick_width(lengths, **pick)
    d = CASES["packed"][0]()
    w = thybrid._pick_width(np.diff(d.canonical().row_ptrs()), **pick)
    At = gtt.Hybrid.from_data(d, device="cpu", **kw)
    Aj = gt.Hybrid.from_data(jdata(d), **kw)
    assert At.ell.width == Aj.ell.width == max(1, w)
    assert At.coo.nnz == Aj.coo.nnz
    assert_same_data(At.to_matrix_data(), Aj.to_matrix_data())
    b = rhs(d.shape[1], 2)
    close(At.apply(torch.from_numpy(b)).numpy(),
          np.asarray(Aj.apply(jnp.asarray(b))), 1e-12)
    with pytest.raises(ValueError, match="column_limit"):
        thybrid._pick_width(np.ones(3, np.int64), "column_limit", 0.8,
                            None)


@pytest.mark.parametrize("case", ["banded", "packed"])
def test_spmv_plan_holds_what_csr_holds(case):
    """The plan carries the planned ``Csr``'s arrays: the banded diagonals,
    or the packed slab on the host and the same compact stream on the
    operator's device."""
    d = CASES[case][0]().canonical()
    A = gtt.Csr.from_data(d, device="cpu")
    P = plan_fast_spmv(d, device="cpu")
    assert P.strategy == A.strategy == case and P.device == CPU
    for name in ("diag_values", "tail_rows", "tail_cols", "tail_vals",
                 "pell_vals", "pell_idx", "pell_qw", "pell_xbase"):
        a, b = getattr(P, name), getattr(A, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    assert P.diag_offsets == A.diag_offsets and P.band_meta == A.band_meta
    assert P.sell_meta == A.sell_meta
    if case == "packed":
        for key, t in P.sell.items():
            assert torch.equal(t, A.sell[key]), key
    else:
        assert P.sell is None
    b = torch.from_numpy(rhs(d.shape[0], 3))
    assert torch.equal(P.apply(b), A.apply(b))
    assert plan_fast_spmv(CASES["classical"][0]().canonical(),
                          device="cpu") is None


def test_ell_truncation_and_imposed_width():
    d = CASES["packed"][0]()
    w = 8
    A = gtt.Ell.from_data(d, width=w, allow_truncate=True, device="cpu")
    Aj = gt.Ell.from_data(jdata(d), width=w, allow_truncate=True)
    slow = gtt.Ell.from_data(d, width=w, allow_truncate=True, fast=False,
                             device="cpu")
    assert A.nnz == Aj.nnz < d.nnz
    assert_same_plan(A.fast_op, Aj.fast_op)
    b = torch.from_numpy(rhs(d.shape[0], 1, seed=3))
    close(A.apply(b).numpy(), slow.apply(b).numpy(), 1e-12)
    small = MatrixData((2, 4), [0, 0, 0, 1], [0, 1, 2, 0],
                       [1.0, 2.0, 3.0, 4.0])
    with pytest.raises(ValueError, match="exceeds the imposed"):
        gtt.Ell.from_data(small, width=2, device="cpu")
    assert gtt.Ell.from_data(small, width=2, allow_truncate=True,
                             device="cpu").nnz == 3


def test_sellp_per_slice_widths():
    """SELL-P pads per slice: one long row only inflates its own slice."""
    n = 64
    rows = np.concatenate([np.zeros(32, np.int64), np.arange(1, n)])
    cols = np.concatenate([np.arange(32), np.zeros(n - 1, np.int64)])
    data = MatrixData((n, n), rows, cols, np.arange(1.0, 32 + n))
    A = gtt.Sellp.from_data(data, slice_size=8, stride_factor=8,
                            device="cpu")
    Aj = gt.Sellp.from_data(jdata(data), slice_size=8, stride_factor=8)
    assert A.slice_widths == Aj.slice_widths
    assert A.slice_widths[0] == 32 and set(A.slice_widths[1:]) == {8}
    assert A.total_storage < gtt.Ell.from_data(data, device="cpu") \
        .values.numel()
    b = rhs(n, 1)
    close(A.apply(torch.from_numpy(b)).numpy(), data.to_dense() @ b, 1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_dense_matches_jax(dtype):
    d = tgen.generate_random_matrix(12, 9, nonzeros_per_row=(1, 6), seed=2,
                                    dtype=dtype)
    At = gtt.Dense.from_data(d, device="cpu")
    Aj = gt.Dense.from_data(jdata(d))
    b = rhs(9, 2).astype(dtype)
    rng = np.random.default_rng(7)
    rp, cp = rng.permutation(12), rng.permutation(9)
    rs, cs = rng.uniform(0.5, 2, 12), rng.uniform(0.5, 2, 9)
    pairs = [
        (At.apply(torch.from_numpy(b)), Aj.apply(jnp.asarray(b))),
        (At.apply_advanced(2.0, torch.from_numpy(b), -0.5,
                           torch.ones(12, 2, dtype=At.dtype)),
         Aj.apply_advanced(2.0, jnp.asarray(b), -0.5, jnp.ones((12, 2)))),
        (At.transpose().data, Aj.transpose().data),
        (At.conj_transpose().data, Aj.conj_transpose().data),
        (At.scale(3.0).data, Aj.scale(3.0).data),
        (At.inv_scale(4.0).data, Aj.inv_scale(4.0).data),
        (At.add_scaled(2.0, At).data, Aj.add_scaled(2.0, Aj).data),
        (At.sub_scaled(2.0, At).data, Aj.sub_scaled(2.0, Aj).data),
        (At.add_scaled_identity(1.5, -2.0).data,
         Aj.add_scaled_identity(1.5, -2.0).data),
        (At.compute_absolute().data, Aj.compute_absolute().data),
        (At.make_complex().data, Aj.make_complex().data),
        (At.get_real().data, Aj.get_real().data),
        (At.get_imag().data, Aj.get_imag().data),
        (At.fill(0.5).data, Aj.fill(0.5).data),
        (At.row_gather([3, 1, 4]).data, Aj.row_gather([3, 1, 4]).data),
        (At.permute(rp, gtt.permute_mode.rows).data,
         Aj.permute(rp, gt.permute_mode.rows).data),
        (At.permute(cp, gtt.permute_mode.inverse_columns).data,
         Aj.permute(cp, gt.permute_mode.inverse_columns).data),
        (At.scale_permute((rp, rs), col_sp=(cp, cs)).data,
         Aj.scale_permute((rp, rs), col_sp=(cp, cs)).data),
        (At.scale_permute((rp, rs), col_sp=(cp, cs), invert=True).data,
         Aj.scale_permute((rp, rs), col_sp=(cp, cs), invert=True).data),
        (At.create_submatrix(slice(2, 9), slice(1, 5)).data,
         Aj.create_submatrix(slice(2, 9), slice(1, 5)).data),
        (At.extract_diagonal().values, Aj.extract_diagonal().values),
        (At.compute_norm2(), Aj.compute_norm2()),
        (At.compute_norm1(), Aj.compute_norm1()),
        (At.compute_dot(At), Aj.compute_dot(Aj)),
        (At.compute_conj_dot(At), Aj.compute_conj_dot(Aj)),
        (At.compute_mean(), Aj.compute_mean()),
        (At.compute_squared_norm2(), Aj.compute_squared_norm2()),
    ]
    for i, (t, j) in enumerate(pairs):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, i
        close(t.numpy(), j, 1e-13)
    assert_same_data(At.to_matrix_data(), Aj.to_matrix_data())
    assert At.shape == Aj.shape == (12, 9)


def test_dense_bf16_accumulates_in_f32():
    a = np.random.default_rng(0).standard_normal((64, 300))
    A = gtt.Dense.create(a, dtype=torch.bfloat16, device="cpu")
    b = torch.from_numpy(rhs(300, 2)).float()
    y = A.apply(b)
    assert y.dtype == torch.float32
    want = A.data.double() @ b.to(torch.bfloat16).double()
    close(y.numpy(), want.numpy(), 1e-6)


def test_sparsity_csr_matches_jax():
    d = tgen.generate_random_matrix(37, 29, nonzeros_per_row=(1, 7), seed=5)
    S = gtt.SparsityCsr.from_data(d, value=2.0, device="cpu")
    Sj = gt.SparsityCsr.from_data(jdata(d), value=2.0)
    assert np.array_equal(S.row_idx.numpy(), np.asarray(Sj.row_idx))
    assert np.array_equal(S.col_idx.numpy(), np.asarray(Sj.col_idx))
    b = rhs(29, 1)
    pattern = (d.canonical().to_dense() != 0).astype(float)
    close(S.apply(torch.from_numpy(b)).numpy(), 2.0 * pattern @ b, 1e-12)
    close(S.apply(torch.from_numpy(b)).numpy(),
          np.asarray(Sj.apply(jnp.asarray(b))), 1e-12)
    np.testing.assert_array_equal(S.to_dense().numpy(),
                                  np.asarray(Sj.to_dense()))
    assert_same_data(S.to_matrix_data(), Sj.to_matrix_data())
    for got, want in zip(S.to_adjacency(), Sj.to_adjacency()):
        assert np.array_equal(got, want)
    A = gtt.Csr.from_data(d, device="cpu")
    assert torch.equal(A.to_sparsity_csr().col_idx, S.col_idx)
    assert gtt.SparsityCsr.from_pattern_of(A).nnz == S.nnz


@pytest.mark.parametrize("case", sorted(CASES))
def test_coo_conversions_match_jax(case):
    d = CASES[case][0]()
    C = gtt.Coo.from_data(d, device="cpu", fast=False)
    Cj = gt.Coo.from_data(jdata(d), fast=False)
    for mine, theirs in ((C.transpose(), Cj.transpose()),
                         (C.conj_transpose(), Cj.conj_transpose())):
        for name in ("row_idx", "col_idx", "values"):
            assert np.array_equal(getattr(mine, name).numpy(),
                                  np.asarray(getattr(theirs, name))), name
        assert mine.shape == theirs.shape
    R, Rj = C.to_csr(), Cj.to_csr()
    assert R.strategy == Rj.strategy == "classical"
    assert np.array_equal(R.row_ptr.numpy(), np.asarray(Rj.row_ptr))
    P, Pj = C.to_csr(strategy="automatical"), Cj.to_csr(
        strategy="automatical")
    assert P.strategy == Pj.strategy
    assert_same_data(P.to_matrix_data(), Pj.to_matrix_data())


@pytest.mark.parametrize("case", sorted(CASES))
def test_csr_methods_match_jax(case):
    d = CASES[case][0]()
    A = gtt.Csr.from_data(d, device="cpu")
    Aj = gt.Csr.from_data(jdata(d))
    assert A.strategy == Aj.strategy
    b = rhs(d.shape[1], 2, seed=5)
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    np.testing.assert_array_equal(A.to_dense().numpy(),
                                  np.asarray(Aj.to_dense()))
    for name, fmt in (("to_ell", "Ell"), ("to_sellp", "Sellp"),
                      ("to_hybrid", "Hybrid"), ("to_fbcsr", "Fbcsr"),
                      ("to_sparsity_csr", "SparsityCsr")):
        mine, theirs = getattr(A, name)(), getattr(Aj, name)()
        assert type(mine).__name__ == fmt and mine.device == CPU
        assert_same_data(mine.to_matrix_data(), theirs.to_matrix_data())
    rng = np.random.default_rng(11)
    n = d.shape[0]
    perm, scale = rng.permutation(n), rng.uniform(0.5, 2.0, n)
    maps = [
        (A.scale(2.5), Aj.scale(2.5)),
        (A.inv_scale(4.0), Aj.inv_scale(4.0)),
        (A.compute_absolute(), Aj.compute_absolute()),
        (A.add_scaled_identity(1.5, -0.5), Aj.add_scaled_identity(1.5, -0.5)),
        (A.permute(perm), Aj.permute(perm)),
        (A.permute(perm, gtt.permute_mode.inverse_rows),
         Aj.permute(perm, gt.permute_mode.inverse_rows)),
        (A.scale_permute(gtt.ScaledPermutation.from_indices(
            perm, scale, device="cpu")),
         Aj.scale_permute(gt.ScaledPermutation.from_indices(perm, scale))),
        (A.scale_permute((perm, scale), mode=gtt.permute_mode.inverse_rows),
         Aj.scale_permute((perm, scale),
                          mode=gt.permute_mode.inverse_rows)),
    ]
    for i, (mine, theirs) in enumerate(maps):
        assert mine.strategy == theirs.strategy, i
        assert_same_data(mine.to_matrix_data(), theirs.to_matrix_data())
        close(mine.apply(bt).numpy(), np.asarray(theirs.apply(bj)), 1e-12)
    sub, subj = (A.create_submatrix(slice(3, 40), slice(5, 50)),
                 Aj.create_submatrix(slice(3, 40), slice(5, 50)))
    assert_same_data(sub.to_matrix_data(), subj.to_matrix_data())
    f32 = A.astype(np.float32)
    assert f32.dtype == torch.float32
    close(f32.apply(bt.float()).numpy(),
          np.asarray(Aj.astype(np.float32).apply(bj.astype(np.float32))),
          1e-5)
    assert A.is_sorted_by_column_index() and A.sort_by_column_index() is A
    assert np.array_equal(A.row_lengths().numpy(),
                          np.asarray(Aj.row_lengths()))
    D = gtt.Csr.from_dense(d.to_dense(), device="cpu")
    assert D.strategy == A.strategy
    assert_same_data(D.to_matrix_data(), A.to_matrix_data())


def test_csr_unsorted_rows_are_sorted_as_jax_sorts_them():
    d = tgen.generate_random_matrix(30, 30, nonzeros_per_row=(2, 6), seed=3)
    A = gtt.Csr.from_data(d, strategy="classical", device="cpu")
    Aj = gt.Csr.from_data(jdata(d), strategy="classical")
    # reverse the columns of every row, as externally assembled arrays may
    order = np.lexsort((-A.col_idx.numpy(), A.row_idx.numpy()))
    A.col_idx, A.values = A.col_idx[order], A.values[order]
    A.row_idx = A.row_idx[order]
    Aj = gt.matrix.csr.dataclass_replace(
        Aj, col_idx=Aj.col_idx[order], values=Aj.values[order],
        row_idx=Aj.row_idx[order])
    assert not A.is_sorted_by_column_index()
    assert not Aj.is_sorted_by_column_index()
    S, Sj = A.sort_by_column_index(), Aj.sort_by_column_index()
    assert S.is_sorted_by_column_index()
    for name in ("row_idx", "col_idx", "values"):
        assert np.array_equal(getattr(S, name).numpy(),
                              np.asarray(getattr(Sj, name))), name


def test_csr_add_scaled_identity_needs_the_diagonal():
    d = MatrixData((3, 3), [0, 1, 2], [1, 2, 0], [1.0, 2.0, 3.0])
    A = gtt.Csr.from_data(d, device="cpu")
    with pytest.raises(gtt.UnsupportedMatrixProperty, match="diagonal"):
        A.add_scaled_identity(1.0, 1.0)


def test_csr_spgemm_and_spgeam_name_their_slice():
    """``Csr.spgemm``/``spgeam`` (once raises naming their slice) against
    the JAX package's on the same matrices: equal patterns, values to
    1e-12, the result on the operands' device."""
    d = tgen.stencil_2d(6)
    e = tgen.generate_random_matrix(36, 36, nonzeros_per_row=(1, 5), seed=8)
    A = gtt.Csr.from_data(d, device="cpu")
    B = gtt.Csr.from_data(e, device="cpu")
    Aj = gt.Csr.from_data(gt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                        d.values))
    Bj = gt.Csr.from_data(gt.MatrixData(e.shape, e.row_idx, e.col_idx,
                                        e.values))
    for got, want in ((A.spgemm(B), Aj.spgemm(Bj)),
                      (A.spgeam(2.0, -0.5, B), Aj.spgeam(2.0, -0.5, Bj))):
        assert got.device == CPU and got.dtype == torch.float64
        g, w = got.to_matrix_data(), want.to_matrix_data()
        assert np.array_equal(g.row_idx, w.row_idx)
        assert np.array_equal(g.col_idx, w.col_idx)
        np.testing.assert_allclose(g.values, w.values, rtol=1e-12)


def test_linop_generic_dtype_device_and_to_dense():
    d = tgen.stencil_2d(5)
    E = gtt.Ell.from_data(d, dtype=np.float32, device="cpu")
    assert E.dtype == torch.float32 and E.device == CPU
    comp = gtt.Composition([E, gtt.Identity(25)])
    np.testing.assert_array_equal(comp.to_dense().numpy(),
                                  E.to_dense().numpy())
    assert isinstance(E @ E, gtt.Composition)


def test_tensorless_operator_is_on_the_default_device(monkeypatch):
    """An operator that holds no tensor (``Identity``) has no device of its
    own: it is on the entry points' default device, and its dense form is
    built there, not on the host."""
    from ginkgo_tpu_torch.base import linop
    asked = []

    def resolve(device=None):
        asked.append(device)
        return torch.device("meta")

    monkeypatch.setattr(linop, "resolve_device", resolve)
    eye = gtt.Identity(6).to_dense()
    assert eye.device.type == "meta" and tuple(eye.shape) == (6, 6)
    assert asked and set(asked) == {None}
    assert gtt.Combination((2.0,), (gtt.Identity(6),)).device.type == "meta"
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        gtt.Identity(6).to_dense()


@pytest.mark.parametrize("case", ["banded", "packed", "classical"])
def test_csr_value_maps_reach_every_value_tensor(case):
    """scale / inv_scale by a tensor scalar and astype map every value
    tensor (classical values, diagonals, tail, the host slab and its
    stream): the result holds what a Csr planned from the mapped entries
    holds, bit for bit."""
    d = CASES[case][0]()
    A = gtt.Csr.from_data(d, device="cpu")
    alpha = torch.tensor(1.7, dtype=torch.float64)
    for got in (A.scale(alpha), A.inv_scale(alpha), A.astype(np.float32)):
        ref = gtt.Csr.from_data(got.to_matrix_data(), dtype=got.dtype,
                                device="cpu")
        assert got.strategy == ref.strategy == A.strategy
        for name in ("values", "diag_values", "tail_vals", "pell_vals"):
            g, w = getattr(got, name), getattr(ref, name)
            assert (g is None) == (w is None), name
            if g is not None:
                assert g.dtype == got.dtype and torch.equal(g, w), name
        assert (got.sell is None) == (ref.sell is None)
        if got.sell is not None:
            assert torch.equal(got.sell["sv"], ref.sell["sv"])
        b = torch.from_numpy(rhs(d.shape[1], 2)).to(got.dtype)
        assert torch.equal(got.apply(b), ref.apply(b))
    assert torch.equal(A.scale(alpha).values, A.scale(1.7).values)


@pytest.mark.parametrize("fmt", FORMATS + ("Dense", "SparsityCsr"))
def test_entry_points_default_to_cuda(fmt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        getattr(gtt, fmt).from_data(tgen.stencil_2d(4))


def test_ell_jacobi_cg_takes_the_jax_iterations():
    """Jacobi-CG with the ``Ell`` operator (its Jacobi built from the
    ``Csr`` of the same data: the JAX ``Ell`` has no diagonal extraction)
    takes the JAX package's iterations, and the port's x is bit for bit
    that of its own ``Csr``: the same planned arrays reach the same
    kernel."""
    d = tgen.stencil_3d(8, points=27)
    b = np.ones(d.shape[0])
    E, A = (gtt.Ell.from_data(d, device="cpu"),
            gtt.Csr.from_data(d, device="cpu"))
    Ej, Aj = gt.Ell.from_data(jdata(d)), gt.Csr.from_data(jdata(d))
    M = Jacobi().generate(A)
    crit = Iteration(400) | ResidualNorm(1e-10)
    re = Cg.solve(E, torch.from_numpy(b), criteria=crit, preconditioner=M)
    ra = Cg.solve(A, torch.from_numpy(b), criteria=crit, preconditioner=M)
    rj = JCg.solve(Ej, jnp.asarray(b),
                   criteria=JIteration(400) | JResidualNorm(1e-10),
                   preconditioner=JJacobi().generate(Aj))
    assert int(re.iterations[0]) == int(np.asarray(rj.iterations)[0]) > 5
    assert bool(re.converged.all())
    assert torch.equal(re.x, ra.x)
    close(re.x.numpy(), np.asarray(rj.x), 1e-10)


def test_hybrid_bicgstab_takes_the_jax_iterations():
    d = build_matrix_data({"fem": 4096, "offscale": 1.2})
    b = np.ones(d.shape[0])
    H = gtt.Hybrid.from_data(d, strategy="minimal_storage_limit",
                             device="cpu")
    Hj = gt.Hybrid.from_data(jdata(d), strategy="minimal_storage_limit")
    assert H.fast_op.strategy == Hj.fast_op.strategy == "packed"
    r = Bicgstab.solve(H, torch.from_numpy(b),
                       criteria=Iteration(400) | ResidualNorm(1e-10))
    rj = JBicgstab.solve(Hj, jnp.asarray(b),
                         criteria=JIteration(400) | JResidualNorm(1e-10))
    assert int(r.iterations[0]) == int(np.asarray(rj.iterations)[0]) > 3
    assert bool(r.converged.all())
    close(r.x.numpy(), np.asarray(rj.x), 1e-9)
