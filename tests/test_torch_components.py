"""Device primitives (``ops/components.py``) and device COO
canonicalization (``ops/device_matrix_data.py``): the port against
ginkgo_tpu on the same seeded inputs, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.matrix.coo import Coo as JCoo
from ginkgo_tpu.ops import components as jc
from ginkgo_tpu.ops import device_matrix_data as jdm
from ginkgo_tpu_torch.ops import components as tc
from ginkgo_tpu_torch.ops import device_matrix_data as tdm


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_prefix_sum_reduce_and_conversions():
    x = np.random.default_rng(1).integers(0, 9, 40)
    out, total = tc.prefix_sum_nonnegative(_t(x))
    jout, jtotal = jc.prefix_sum_nonnegative(jnp.asarray(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert int(total) == int(jtotal)
    assert int(tc.reduce_add_array(_t(x), 3)) == int(
        jc.reduce_add_array(jnp.asarray(x), 3))
    idxs = np.sort(np.random.default_rng(2).integers(0, 12, 50))
    idxs[-1] = 12                            # outside the rows: dropped
    ptrs = tc.convert_idxs_to_ptrs(_t(idxs), 12)
    jptrs = jc.convert_idxs_to_ptrs(jnp.asarray(idxs), 12)
    np.testing.assert_array_equal(ptrs.numpy(), np.asarray(jptrs))
    back = tc.convert_ptrs_to_idxs(ptrs, 49)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jc.convert_ptrs_to_idxs(jptrs, 49)))
    assert back.dtype == torch.int32


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("dtype", [np.float64, np.int64],
                         ids=["f64", "i64"])
def test_segment_reduce_matches_jax(op, dtype):
    rng = np.random.default_rng(3)
    v = (rng.standard_normal(60) * 10).astype(dtype)
    ids = rng.integers(0, 9, 60)
    ids[ids == 4] = 5                        # segment 4 stays empty
    got = tc.segment_reduce(_t(v), _t(ids), 10, op)
    want = jc.segment_reduce(jnp.asarray(v), jnp.asarray(ids), 10, op)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="unknown segment op"):
        tc.segment_reduce(_t(v), _t(ids), 10, "mean")


def test_bitvector_get_and_rank_match_jax():
    rng = np.random.default_rng(4)
    bits = rng.random(203) < 0.4
    bits[[0, 31, 32, 63, 64, 202]] = True
    bv, jbv = tc.Bitvector(_t(bits)), jc.Bitvector(bits)
    np.testing.assert_array_equal(bv.words.numpy(),
                                  np.asarray(jbv.words).astype(np.int64))
    for i in [0, 1, 5, 31, 32, 33, 63, 64, 100, 202]:
        assert bool(bv.get(i)) == bool(jbv.get(i)) == bits[i], i
    for i in range(203):
        assert int(bv.rank(i)) == int(jbv.rank(i)) == int(bits[:i].sum())
    ranks = bv.rank(torch.arange(203))
    np.testing.assert_array_equal(ranks.numpy(),
                                  np.cumsum(bits) - bits)


def test_host_components_match_jax():
    ds, jds = tc.DisjointSets(8), jc.DisjointSets(8)
    for a, b in [(0, 1), (2, 3), (1, 3), (6, 7)]:
        ds.union(a, b)
        jds.union(a, b)
    assert [ds.find(i) for i in range(8)] == [jds.find(i) for i in range(8)]
    assert ds.num_sets() == jds.num_sets() == 4
    v = np.random.default_rng(5).integers(0, 1000, 200)
    rmq, jrmq = tc.RangeMinimumQuery(v), jc.RangeMinimumQuery(v)
    for lo, hi in [(0, 200), (5, 6), (13, 57), (100, 199), (0, 1)]:
        assert rmq.argmin(lo, hi) == jrmq.argmin(lo, hi)
        assert rmq.min(lo, hi) == v[lo:hi].min()
    with pytest.raises(ValueError):
        rmq.argmin(5, 5)
    q = tc.AddressablePriorityQueue()
    q.insert("a", 5)
    q.insert("b", 3)
    q.insert("c", 9)
    q.update_key("c", 1)
    assert len(q) == 3 and "c" in q
    assert [q.pop_min(), q.pop_min()] == [("c", 1), ("b", 3)]
    q.update_key("a", 10)
    assert q.pop_min() == ("a", 10)
    with pytest.raises(IndexError):
        q.pop_min()


def _triplets(seed, n=10, cap=48):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, cap)
    cols = rng.integers(0, n, cap)
    vals = rng.standard_normal(cap)
    vals[::7] = 0.0                      # explicit zeros
    vals[5] = -vals[6]                   # a pair that may cancel
    rows[5], cols[5] = rows[6], cols[6]
    rows[-4:] = n                        # padding entries
    return n, rows, cols, vals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_and_sum_duplicates_match_jax_bit_for_bit(seed):
    n, rows, cols, vals = _triplets(seed)
    got = tdm.sort_row_major(_t(rows), _t(cols), _t(vals), n, n)
    want = jdm.sort_row_major(jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(vals), n, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = tdm.sum_duplicates(_t(rows), _t(cols), _t(vals), n, n)
    want = jdm.sum_duplicates(jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(vals), n, n)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15)
    got = tdm.remove_zeros(_t(rows), _t(cols), _t(vals), n)
    want = jdm.remove_zeros(jnp.asarray(rows), jnp.asarray(cols),
                            jnp.asarray(vals), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 3])
def test_canonicalize_device_matches_host_canonical(seed):
    n, rows, cols, vals = _triplets(seed)
    live = rows < n
    host = gtt.MatrixData((n, n), rows[live], cols[live],
                          vals[live]).canonical()
    coo = gtt.Coo(row_idx=_t(rows.astype(np.int32)),
                  col_idx=_t(cols.astype(np.int32)), values=_t(vals),
                  shape=(n, n), nnz=len(rows))
    out = tdm.canonicalize_device(coo)
    assert out.nnz == host.nnz
    got = out.to_matrix_data()
    np.testing.assert_array_equal(got.row_idx, host.row_idx)
    np.testing.assert_array_equal(got.col_idx, host.col_idx)
    np.testing.assert_allclose(got.values, host.values, rtol=1e-15)
    assert (out.row_idx[out.nnz:] == n).all()
    jout = jdm.canonicalize_device(JCoo(
        row_idx=jnp.asarray(rows, jnp.int32),
        col_idx=jnp.asarray(cols, jnp.int32), values=jnp.asarray(vals),
        shape=(n, n), nnz=len(rows)))
    np.testing.assert_array_equal(out.row_idx.numpy(),
                                  np.asarray(jout.row_idx))
    np.testing.assert_array_equal(out.col_idx.numpy(),
                                  np.asarray(jout.col_idx))
    np.testing.assert_allclose(out.to_dense().numpy(),
                               np.asarray(jout.to_dense()), rtol=1e-15)
    np.testing.assert_allclose(out.to_dense().numpy(),
                               gt.MatrixData((n, n), rows[live], cols[live],
                                             vals[live]).to_dense(),
                               rtol=1e-14, atol=1e-15)
