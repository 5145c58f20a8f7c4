"""Distributed tier (``distributed/``, ``base/collections.py``,
``interop.distributed_from_arrays``): the port against ginkgo_tpu on the
same numpy inputs, on the CPU, in f64 as the reference's tests run (its
mesh: the 8 virtual CPU devices of ``tests/conftest.py``; the port's: P
parts on the host).

The host planning is the reference's verbatim, so every planned array is
held element for element; the SpMV to 1e-12 relative (its sums run in
another order), and the two communicators bit for bit against each
other."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import ginkgo_tpu.distributed as jd
from ginkgo_tpu.base import collections as jcol
from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu_torch.base import collections as tcol
from ginkgo_tpu_torch.base.exceptions import NotSupportedError
from ginkgo_tpu_torch.base.matrix_data import MatrixData
from ginkgo_tpu_torch.distributed import (DistributedMatrix, IndexMap, Mesh,
                                          Partition, Vector,
                                          assemble_distributed,
                                          distribute_vector, make_mesh,
                                          read_distributed)
from ginkgo_tpu_torch.distributed import matrix as tmatrix
from ginkgo_tpu_torch.interop import distributed_from_arrays
from ginkgo_tpu_torch.utils.generators import (generate_random_matrix,
                                               stencil_2d, stencil_3d)

FIELDS = tmatrix.INDEX_ARRAYS + tmatrix.VALUE_ARRAYS + tuple(
    tmatrix.SLAB_ARRAYS)


def jmesh(P):
    return JMesh(np.array(jax.devices()[:P]), ("rows",))


def tmesh(P):
    return make_mesh((P,), ("rows",), device="cpu")


def jdata(d):
    return JMatrixData(d.shape, d.row_idx, d.col_idx, d.values)


def fem(n=4096, n_off=24, spread=400, seed=3):
    """``tests/test_distributed.py::test_dist_packed_local_blocks``'s
    unstructured pattern with column locality (packed local blocks)."""
    rng = np.random.default_rng(seed)
    offs = rng.integers(-spread, spread, (n // 128, n_off))
    pick = rng.random((n, n_off)) < 0.6
    r = np.repeat(np.arange(n), n_off).reshape(n, n_off)
    c = np.clip(r + offs[np.arange(n) // 128], 0, n - 1)
    key = np.unique(r[pick] * n + c[pick])
    return MatrixData((n, n), key // n, key % n,
                      rng.standard_normal(key.size))


LAYOUTS = {"banded": lambda: stencil_3d(16, points=27),
           "packed": fem,
           "gather": lambda: generate_random_matrix(
               2048, 2048, nonzeros_per_row=(1, 5), seed=5)}


def layout_of(A):
    return ("banded" if A.dia_vals is not None
            else "packed" if A.pell_vals is not None else "gather")


def both(data, P, comm="dense"):
    n = data.shape[0]
    Aj = jd.read_distributed(jdata(data), jd.Partition.
                             build_from_global_size_uniform(P, n), jmesh(P),
                             comm=comm)
    part = Partition.build_from_global_size_uniform(P, n)
    At = read_distributed(data, part, tmesh(P), comm=comm)
    return Aj, At, part


def host(x):
    return None if x is None else np.asarray(x)


# -- Partition, IndexMap, collections -----------------------------------------

def test_partition_and_index_map_equal():
    for P, n in ((4, 10), (3, 8), (1, 5), (8, 1000)):
        j = jd.Partition.build_from_global_size_uniform(P, n)
        t = Partition.build_from_global_size_uniform(P, n)
        g = np.arange(n)
        assert np.array_equal(j.ranges, t.ranges)
        assert (j.local_size, j.padded_size) == (t.local_size, t.padded_size)
        for fn in ("owner_of", "to_local", "padded_slot"):
            assert np.array_equal(getattr(j, fn)(g), getattr(t, fn)(g))
        x = np.arange(2.0 * n).reshape(n, 2)
        assert np.array_equal(t.to_padded(x), j.to_padded(x))
        assert np.array_equal(t.from_padded(t.to_padded(x)), x)
    t = Partition.build_from_mapping([0, 0, 1, 1, 1, 2], 3)
    assert np.array_equal(t.ranges, [0, 2, 5, 6])
    with pytest.raises(ValueError):
        Partition.build_from_mapping([0, 1, 0], 2)
    p = Partition.build_from_global_size_uniform(4, 16)
    jp = jd.Partition.build_from_global_size_uniform(4, 16)
    touched = np.array([2, 4, 5, 7, 9, 15])
    t, j = IndexMap.build(p, 1, touched), jd.IndexMap.build(jp, 1, touched)
    for fn in ("get_remote_global_idxs", "get_remote_local_idxs",
               "get_remote_target_ids"):
        assert np.array_equal(getattr(t, fn)(), getattr(j, fn)())
    g = np.array([4, 7, 2, 15, 9])
    assert np.array_equal(t.map_to_local(g), j.map_to_local(g))
    assert np.array_equal(t.map_to_global(t.map_to_local(g)), g)
    with pytest.raises(ValueError):
        t.map_to_local([3])
    with pytest.raises(ValueError):
        t.map_to_global([8])


def test_collections_equal():
    sizes = [3, 0, 5, 2]
    segs = [np.arange(3.0), np.zeros(0), np.linspace(0, 1, 5),
            np.array([7.0, -2.0])]
    for t, j in ((tcol.SegmentedArray.from_sizes(sizes, device="cpu"),
                  jcol.SegmentedArray.from_sizes(sizes)),
                 (tcol.SegmentedArray.from_segments(segs, device="cpu"),
                  jcol.SegmentedArray.from_segments(segs))):
        assert t.num_segments == j.num_segments
        assert np.array_equal(t.offsets.numpy(), np.asarray(j.offsets))
        assert np.array_equal(t.segment_ids().numpy(),
                              np.asarray(j.segment_ids()))
        np.testing.assert_allclose(t.segment_sums().numpy(),
                                   np.asarray(j.segment_sums()), rtol=1e-15)
        assert np.array_equal(t.segment(2).numpy(), np.asarray(j.segment(2)))
    idx = [3, 4, 5, 9, 12, 13, 40]
    t, j = tcol.IndexSet(50, idx), jcol.IndexSet(50, idx)
    q = np.arange(-2, 52)
    assert t.num_subsets == j.num_subsets == 4
    assert t.get_num_elems() == j.get_num_elems() == 7
    for fn in ("contains", "get_local_index", "get_global_index"):
        assert np.array_equal(getattr(t, fn)(q), getattr(j, fn)(q))
    assert np.array_equal(t.to_global_indices(), j.to_global_indices())
    assert tcol.IndexSet(5).get_num_elems() == 0
    with pytest.raises(ValueError):
        tcol.IndexSet(5, [7])


# -- from_data: every planned array -------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("comm", ["dense", "neighborhood"])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_from_data_arrays_equal(P, comm, layout):
    data = LAYOUTS[layout]()
    Aj, At, _ = both(data, P, comm)
    assert layout_of(At) == layout_of(Aj) == layout
    for name in FIELDS:
        j, t = host(getattr(Aj, name)), getattr(At, name)
        assert (j is None) == (t is None), name
        if j is not None:
            assert np.array_equal(j, t.numpy()), name
    for name in tmatrix.STATIC_FIELDS:
        assert getattr(Aj, name) == getattr(At, name), name
    assert At.comm == comm and At.device == torch.device("cpu")


# -- the SpMV -----------------------------------------------------------------

def _complexify(data):
    rng = np.random.default_rng(11)
    return MatrixData(data.shape, data.row_idx, data.col_idx,
                      data.values * (1 + 0.3j)
                      + 0.1j * rng.standard_normal(data.nnz))


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_spmv_matches_reference(dtype):
    spmv_case("gather", dtype)


def spmv_case(layout, dtype):
    """The port's SpMV under both communicators against the reference's
    (``dense``: the neighborhood schedule is held array for array by
    ``test_from_data_arrays_equal``), the numpy product, and the port
    over the reference's own planned arrays."""
    data = LAYOUTS[layout]()
    if dtype == "complex128":
        data = _complexify(data)
    n, P = data.shape[0], 4
    x = np.random.default_rng(P).standard_normal((n, 2)).astype(dtype)
    ys = {}
    for comm in ("dense", "neighborhood"):
        Aj, At, part = both(data, P, comm)
        assert layout_of(At) == layout
        ys[comm] = At.apply(distribute_vector(x, part, At.mesh))
        yt = part.from_padded(ys[comm].numpy())
        want = data.to_dense() @ x
        scale = np.abs(want).max()
        assert np.abs(yt - want).max() <= 1e-12 * scale
        if comm == "dense":
            yj = part.from_padded(np.asarray(Aj.apply(
                jd.distribute_vector(x, Aj.host_partition, jmesh(P)))))
            assert np.abs(yt - yj).max() <= 1e-12 * scale
        # the reference's own planned arrays, carried across
        arrays = {name: host(getattr(Aj, name)) for name in FIELDS}
        static = {name: getattr(Aj, name) for name in tmatrix.STATIC_FIELDS}
        Ac = distributed_from_arrays(arrays, static, tmesh(P))
        assert torch.equal(Ac.apply(distribute_vector(x, part, Ac.mesh)),
                           ys[comm])
    # the same ghost values summed in the same order: the same bits
    assert torch.equal(ys["dense"], ys["neighborhood"])


def test_spmv_single_vector_and_pads():
    """A natural size that does not divide: zero pad rows, a 1-D
    vector."""
    data = stencil_2d(8, points=9)
    Aj, At, part = both(data, 3)
    x = np.random.default_rng(1).standard_normal(64)
    y = At.apply(distribute_vector(x, part, At.mesh))
    assert y.shape == (part.padded_size,)
    np.testing.assert_allclose(part.from_padded(y.numpy()),
                               data.to_dense() @ x, rtol=1e-12, atol=1e-12)
    assert not torch.any(y[part.padded_size - 1:])


# -- to_dense, extract_diagonal, the schedule-only builds ---------------------

def test_to_dense_and_extract_diagonal():
    data = generate_random_matrix(20, 20, nonzeros_per_row=(1, 6), seed=3)
    Aj, At, part = both(data, 4)
    assert np.array_equal(At.to_dense().numpy(), Aj.to_dense())
    slot = part.padded_slot(np.arange(20))
    np.testing.assert_allclose(At.to_dense().numpy()[np.ix_(slot, slot)],
                               data.to_dense(), rtol=1e-14)
    data = stencil_2d(6, points=5)
    Aj, At, part = both(data, 4)
    d = At.extract_diagonal().values.numpy()
    assert np.array_equal(d, np.asarray(Aj.extract_diagonal().values))
    np.testing.assert_allclose(part.from_padded(d), np.diag(data.to_dense()),
                               rtol=1e-14)


def test_neighborhood_to_dense_reconstructs_schedule():
    data = stencil_2d(8, points=9)
    part = Partition.build_from_global_size_uniform(8, 64)
    A = DistributedMatrix.from_data(data, part, mesh="schedule-only",
                                    comm="neighborhood")
    np.testing.assert_allclose(A.to_dense().numpy()[:64, :64],
                               data.to_dense(), rtol=1e-14)
    with pytest.raises(ValueError, match="schedule-only"):
        A.apply(torch.ones(64))


def test_neighborhood_schedule_memory_is_o_neighbors():
    data = stencil_3d(16, points=27)
    part = Partition.build_from_global_size_uniform(64, data.shape[0])
    A = DistributedMatrix.from_data(data, part, mesh="schedule-only",
                                    comm="auto")
    assert A.comm == "neighborhood" and len(A.shifts) <= 8
    assert A.send_idx is None and A.ghost_owner is None
    assert A.send_nb.shape[1] == sum(A.shift_sizes)
    Ad = DistributedMatrix.from_data(data, part, mesh="schedule-only",
                                     comm="dense")
    assert Ad.send_nb is None
    assert A.send_nb.shape[1] * 8 <= (Ad.send_idx.shape[1]
                                      * Ad.send_idx.shape[2])
    Aj = jd.DistributedMatrix.from_data(jdata(data), jd.Partition.
                                        build_from_global_size_uniform(
                                            64, data.shape[0]),
                                        mesh="schedule-only", comm="auto")
    assert (Aj.comm, Aj.shifts, Aj.shift_sizes) == (A.comm, A.shifts,
                                                    A.shift_sizes)
    assert np.array_equal(np.asarray(Aj.send_nb), A.send_nb.numpy())


def test_neighborhood_device_bytes_scale_with_neighbors_p256():
    data = stencil_3d(32, points=27)
    P = 256
    part = Partition.build_from_global_size_uniform(P, data.shape[0])
    A = DistributedMatrix.from_data(data, part, mesh="schedule-only",
                                    comm="neighborhood")
    assert A.send_idx is None
    sched_elems = A.send_nb.numel() + A.ghost_roff.numel()
    per_part = sum(A.shift_sizes) + A.ghost_roff.shape[1]
    assert sched_elems == P * per_part
    assert sched_elems * 8 <= P * P * max(A.shift_sizes)


# -- the mesh -----------------------------------------------------------------

def test_mesh_places_every_part_on_one_device(monkeypatch):
    m = Mesh(np.array([torch.device("cpu")] * 8).reshape(4, 2),
             ("rows", "cols"))
    assert m.shape == {"rows": 4, "cols": 2}
    assert m.device == torch.device("cpu")
    two = Mesh(np.array([torch.device("cpu"), torch.device("meta")]),
               ("rows",))
    with pytest.raises(NotSupportedError, match="queue 1 item 14"):
        two.device
    data = stencil_2d(4, points=5)
    part = Partition.build_from_global_size_uniform(2, 16)
    with pytest.raises(NotSupportedError, match="queue 1 item 14"):
        read_distributed(data, part, two)
    with pytest.raises(ValueError, match="axis"):
        read_distributed(data, part, tmesh(4))
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array([torch.device("cpu")] * 2), ("rows", "cols"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        make_mesh((2,), ("rows",))
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        read_distributed(data, part)


# -- Vector, assembly ---------------------------------------------------------

def test_vector_matches_reference():
    p = Partition.build_from_global_size_uniform(4, 18)
    jp = jd.Partition.build_from_global_size_uniform(4, 18)
    x = np.arange(54.0).reshape(18, 3) - 20
    t, j = Vector.from_global(x, p, tmesh(4)), jd.Vector.from_global(
        x, jp, jmesh(4))
    o = Vector.from_global(x[::-1].copy(), p, tmesh(4))
    jo = jd.Vector.from_global(x[::-1].copy(), jp, jmesh(4))
    assert t.shape == tuple(j.shape)
    for fn in ("compute_norm2", "compute_norm1"):
        np.testing.assert_allclose(getattr(t, fn)().numpy(),
                                   np.asarray(getattr(j, fn)()), rtol=1e-14)
    for fn in ("compute_dot", "compute_conj_dot"):
        np.testing.assert_allclose(getattr(t, fn)(o).numpy(),
                                   np.asarray(getattr(j, fn)(jo)), rtol=1e-14)
    np.testing.assert_array_equal(t.scale(2.0).add_scaled(-1.0, o)
                                  .to_global(),
                                  j.scale(2.0).add_scaled(-1.0, jo)
                                  .to_global())
    sub = t.create_subvector(slice(1, 3))
    np.testing.assert_array_equal(sub.to_global(), x[:, 1:3])
    np.testing.assert_array_equal(t.local_view(3), j.local_view(3))


@pytest.mark.parametrize("mode", ["communicate", "local_only"])
def test_assemble_distributed_matches_reference(mode):
    rng = np.random.default_rng(2)
    n, P = 40, 4
    contribs = []
    for rank in range(P):
        r = rng.integers(0, n, 60)
        c = np.clip(r + rng.integers(-3, 4, 60), 0, n - 1)
        contribs.append(MatrixData((n, n), np.concatenate([r, np.arange(n)]),
                                   np.concatenate([c, np.arange(n)]),
                                   np.concatenate([rng.standard_normal(60),
                                                   np.full(n, 4.0)])))
    part = Partition.build_from_global_size_uniform(P, n)
    At = assemble_distributed(contribs, part, tmesh(P), mode=mode)
    Aj = jd.assemble_distributed([jdata(c) for c in contribs],
                                 jd.Partition.build_from_global_size_uniform(
                                     P, n), jmesh(P), mode=mode)
    assert np.array_equal(At.to_dense().numpy(), Aj.to_dense())
    with pytest.raises(ValueError, match="unknown assembly mode"):
        assemble_distributed(contribs, part, tmesh(P), mode="gather")
    with pytest.raises(ValueError, match="no contributions"):
        assemble_distributed([], part, tmesh(P))
