"""The compact sliced stream behind kernels B, G and H
(``ops/spmv_sell.py``).

Each planned slab (packed-slot, windowed-ELL, chunk-ELL) is repacked into
32-row slices without the slab's padding lanes.  Held here:

- the stream's plain version against the slab's plain version in the port
  and in ``ginkgo_tpu`` (``ops/spmv_packed.pell_spmv_reference``,
  ``ops/attic/spmv_windowed.well_spmv_reference``,
  ``ops/attic/spmv_chunked.cell_spmv_reference``) on the same planned
  arrays, k in {1, 3, 9}, f32 and f64.  Tolerance relative to max |y|:
  1e-12 in f64, 1e-5 in f32 (the sums run in another order);
- the stream holds exactly the slab's nonzero lanes, each row in slab
  order, with window-relative columns in [0, XW), padded rows at value 0
  and column 0, and the same stream from a second build;
- on a permuted stencil the stream carries at most 1.1 times the kept
  entries where the slab carries at least 3 times;
- ``Csr`` builds it whenever it is given a slab (``from_data``,
  ``interop.csr_from_arrays``, the constructor), and a packed ``Csr``
  without one raises on apply.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu_torch as gtt
from ginkgo_tpu.ops import spmv_packed as jpk
from ginkgo_tpu.ops.attic import spmv_chunked as jch
from ginkgo_tpu.ops.attic import spmv_windowed as jwin
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.interop import csr_from_arrays
from ginkgo_tpu_torch.ops import spmv_packed, spmv_sell
from ginkgo_tpu_torch.ops.attic import spmv_chunked, spmv_windowed
from ginkgo_tpu_torch.utils import generators as tgen

RTOL = {np.float64: 1e-12, np.float32: 1e-5}
PACKED_ARRAYS = ("vals", "idx", "qw", "xbase_row")


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rtol)


def _fem_like(n, n_off=24, spread=500, seed=0):
    """The unstructured pattern of tests/test_spmv_packed.py."""
    rng = np.random.default_rng(seed)
    offs = rng.integers(-spread, spread, (-(-n // 128), n_off))
    pick = rng.random((n, n_off)) < 0.6
    r = np.repeat(np.arange(n), n_off).reshape(n, n_off)
    c = np.clip(r + offs[np.arange(n) // 128], 0, n - 1)
    key = np.unique(r[pick] * n + c[pick])
    rows, cols = key // n, key % n
    return gtt.MatrixData((n, n), rows, cols,
                          rng.standard_normal(rows.size))


def _rect():
    d = tgen.generate_random_matrix(1100, 900, nonzeros_per_row=(1, 9),
                                    seed=3)
    return gtt.MatrixData(d.shape, d.row_idx,
                          np.minimum(d.row_idx * 900 // 1100
                                     + d.col_idx % 40, 899), d.values)


def _dense_row():
    """fem_like plus one full row, which overflows the slot budget and
    spills to the COO tail."""
    d = _fem_like(2048, seed=2)
    n = d.shape[0]
    return gtt.MatrixData((n, n), np.concatenate([d.row_idx, np.full(n, 5)]),
                          np.concatenate([d.col_idx, np.arange(n)]),
                          np.concatenate([d.values, np.linspace(-1, 1, n)]))


def _random_local(n, lo_deg, hi_deg, bw, seed):
    """The attic tests' random matrix: varying degree, columns within
    +-bw."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(lo_deg, hi_deg, n)
    rows = np.repeat(np.arange(n), deg)
    cols = np.clip(rows + rng.integers(-bw, bw, rows.size), 0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = key // n, key % n
    return gtt.MatrixData((n, n), rows, cols, rng.standard_normal(rows.size))


# the matrices of tests/test_torch_spmv.py's packed cases
PACKED_CASES = {
    "fem_like": lambda: _fem_like(2000, seed=1),
    "permuted": lambda: tgen.permute_locally(
        tgen.stencil_3d(16, 16, 8, points=27)),
    "rect": _rect,
    "dense_row_tail": _dense_row,
}
# the attic tests' cases
CHUNKED_CASES = {
    "local_3000": lambda: _random_local(3000, 5, 30, 400, 0),
    "tight_2500": lambda: _random_local(2500, 1, 8, 50, 1),
    "spread_1500": lambda: _random_local(1500, 20, 64, 1400, 2),
    "fem_4096": lambda: build_matrix_data({"fem": 4096, "offscale": 1.2}),
}


@functools.lru_cache(maxsize=None)
def _packed(name):
    d = PACKED_CASES[name]().canonical()
    layout, tail, stats = spmv_packed.plan_packed_layout(d, d.values)
    assert layout is not None
    assert (stats["tail_nnz"] > 0) == (name == "dense_row_tail")
    return d, layout


@functools.lru_cache(maxsize=None)
def _chunked(name, capped):
    d = CHUNKED_CASES[name]().canonical()
    layout, tail, stats = spmv_chunked.plan_chunked_layout(
        d, d.values, **({"wv_cap": 2} if capped else {}))
    assert (stats["tail_nnz"] > 0) == capped
    return d, layout


@functools.lru_cache(maxsize=None)
def _windowed(name, capped):
    """Kernel G's slab of an attic case; ``capped`` forces a larger tail
    (the attic tests' ``h_quantile=0.5``; the default keeps 99.5 %)."""
    d = CHUNKED_CASES[name]().canonical()
    layout, tail, stats = spmv_windowed.plan_windowed_layout(
        d, d.values, **({"h_quantile": 0.5} if capped else {}))
    assert stats["tail_nnz"] > 0 or not capped
    return d, layout


def _stream(kind, layout, dtype=np.float64):
    """(slab arrays, stream, stream meta) of a planned layout whose
    values are cast to ``dtype``."""
    names = {"packed": PACKED_ARRAYS, "chunked": spmv_chunked.ARRAYS,
             "windowed": spmv_windowed.ARRAYS}[kind]
    arrays = [torch.from_numpy(layout[a]) for a in names]
    arrays[0] = arrays[0].to(torch.from_numpy(np.zeros(0, dtype)).dtype)
    if kind == "windowed":                  # q0 serves the TPU only
        vals, c16, _, xbase_row = arrays
        sell, smeta = spmv_sell.sell_from_windowed(vals, c16, xbase_row,
                                                   layout["meta"])
        return arrays, sell, smeta
    build = (spmv_sell.sell_from_packed if kind == "packed"
             else spmv_sell.sell_from_chunked)
    sell, smeta = build(*arrays, layout["meta"])
    return arrays, sell, smeta


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
@pytest.mark.parametrize("k", [1, 3, 9])
@pytest.mark.parametrize("name", list(PACKED_CASES))
def test_packed_stream_matches_slab_oracles(name, k, dtype):
    d, layout = _packed(name)
    arrays, sell, smeta = _stream("packed", layout, dtype)
    x = np.random.default_rng(k).standard_normal((d.shape[1], k)).astype(
        dtype)
    got = spmv_sell.sell_spmv_reference(sell, smeta, torch.from_numpy(x))
    assert got.shape == (d.shape[0], k) and got.dtype == arrays[0].dtype
    port = spmv_packed.pell_spmv_reference(*arrays, layout["meta"],
                                           torch.from_numpy(x))
    jax = jpk.pell_spmv_reference(*(jnp.asarray(a.numpy()) for a in arrays),
                                  layout["meta"], jnp.asarray(x))
    _close(got.numpy(), port.numpy(), RTOL[dtype])
    _close(got.numpy(), jax, RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
@pytest.mark.parametrize("k", [1, 3, 9])
@pytest.mark.parametrize("capped", [False, True], ids=["", "capped"])
@pytest.mark.parametrize("name", list(CHUNKED_CASES))
def test_chunked_stream_matches_slab_oracles(name, capped, k, dtype):
    d, layout = _chunked(name, capped)
    arrays, sell, smeta = _stream("chunked", layout, dtype)
    x = np.random.default_rng(k).standard_normal((d.shape[1], k)).astype(
        dtype)
    got = spmv_sell.sell_spmv_reference(sell, smeta, torch.from_numpy(x))
    assert got.shape == (d.shape[0], k) and got.dtype == arrays[0].dtype
    port = spmv_chunked.cell_spmv_reference(*arrays, layout["meta"],
                                            torch.from_numpy(x))
    jax = jch.cell_spmv_reference(*(jnp.asarray(a.numpy()) for a in arrays),
                                  layout["meta"], jnp.asarray(x))
    _close(got.numpy(), port.numpy(), RTOL[dtype])
    _close(got.numpy(), jax, RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
@pytest.mark.parametrize("k", [1, 3, 9])
@pytest.mark.parametrize("capped", [False, True], ids=["", "capped"])
@pytest.mark.parametrize("name", list(CHUNKED_CASES))
def test_windowed_stream_matches_slab_oracles(name, capped, k, dtype):
    d, layout = _windowed(name, capped)
    arrays, sell, smeta = _stream("windowed", layout, dtype)
    x = np.random.default_rng(k).standard_normal((d.shape[1], k)).astype(
        dtype)
    got = spmv_sell.sell_spmv_reference(sell, smeta, torch.from_numpy(x))
    assert got.shape == (d.shape[0], k) and got.dtype == arrays[0].dtype
    port = spmv_windowed.well_spmv_reference(*arrays, layout["meta"],
                                             torch.from_numpy(x))
    jax = jwin.well_spmv_reference(*(jnp.asarray(a.numpy())
                                     for a in arrays), layout["meta"],
                                   jnp.asarray(x))
    _close(got.numpy(), port.numpy(), RTOL[dtype])
    _close(got.numpy(), jax, RTOL[dtype])


def _slab_rows(kind, layout):
    """Each row's nonzero slab lanes in slab order (vreg, then sublane),
    left-aligned: (values, window-relative columns), zeros past the row's
    last entry."""
    meta = dict(layout["meta"])
    Gs, Wv = meta["Gs"], meta.get("Wv", meta.get("w8"))
    vals = layout["vals"].reshape(Gs, 8, Wv, 8, 128).astype(np.float64)
    if kind == "windowed":                  # window-relative already
        col = layout["c16"].reshape(Gs, 8, Wv, 8, 128).astype(np.int64)
    elif kind == "packed":
        qw = layout["qw"].reshape(Gs, 8, Wv, 1, 1).astype(np.int64)
        i = layout["idx"].reshape(Gs, 8, Wv, 8, 128).astype(np.int64)
        col = (8 * qw + (i >> 7)) * 128 + (i & 127)
    else:
        qid = layout["qid"].reshape(Gs, 8, Wv, 1, 1).astype(np.int64)
        col = qid * 128 + layout["lanes"].reshape(
            Gs, 8, Wv, 8, 128).astype(np.int64)
    order = (0, 1, 4, 2, 3)                # (row in superblock, v, s)
    vals = vals.transpose(order).reshape(Gs * 1024, Wv * 8)
    col = col.transpose(order).reshape(Gs * 1024, Wv * 8)
    keep = vals != 0
    count = keep.sum(axis=1)
    out_v = np.zeros((vals.shape[0], max(int(count.max()), 1)))
    out_c = np.zeros(out_v.shape, np.int64)
    rows, pos = np.nonzero(keep)
    rank = np.arange(rows.size) - (np.cumsum(count) - count)[rows]
    out_v[rows, rank] = vals[keep]
    out_c[rows, rank] = col[keep]
    return out_v, out_c, count


def _stream_rows(sell, smeta):
    """The stream read row by row: entry j of lane l of slice s at
    sp[s] + 32 j + l, left-aligned as ``_slab_rows``."""
    sv = sell["sv"].double().numpy()
    sc = sell["sc"].numpy().astype(np.int64)
    sp = sell["sp"].numpy()
    width = np.diff(sp) // 32
    out_v = np.zeros((32 * len(width), max(int(width.max()), 1)))
    out_c = np.zeros(out_v.shape, np.int64)
    for s, w in enumerate(width):
        block = slice(sp[s], sp[s + 1])
        out_v[32 * s:32 * s + 32, :w] = sv[block].reshape(w, 32).T
        out_c[32 * s:32 * s + 32, :w] = sc[block].reshape(w, 32).T
    return out_v, out_c, width


STRUCTURE_CASES = ([("packed", name, False) for name in PACKED_CASES]
                   + [(kind, name, capped)
                      for kind in ("chunked", "windowed")
                      for name in CHUNKED_CASES for capped in (False, True)])
_SLABS = {"packed": lambda name, capped: _packed(name),
          "chunked": _chunked, "windowed": _windowed}


@pytest.mark.parametrize("kind,name,capped", STRUCTURE_CASES,
                         ids=[f"{k}-{n}{'-capped' * c}"
                              for k, n, c in STRUCTURE_CASES])
def test_stream_holds_the_slab_nonzero_lanes(kind, name, capped):
    d, layout = _SLABS[kind](name, capped)
    _, sell, smeta = _stream(kind, layout)
    meta, sm = dict(layout["meta"]), dict(smeta)
    n = d.shape[0]
    assert sm["n"] == n and sm["m"] == d.shape[1]
    assert sm["n_slices"] == -(-n // 32) and sm["XW"] == meta["XW"]
    assert sell["sv"].dtype == torch.float64
    assert sell["sc"].dtype == torch.int16 and sell["sp"].dtype == torch.int64
    assert torch.equal(sell["xbase"], torch.from_numpy(layout["xbase_row"]))
    sc = sell["sc"].numpy()
    assert sc.min() >= 0 and sc.max() < meta["XW"]
    want_v, want_c, count = _slab_rows(kind, layout)
    got_v, got_c, width = _stream_rows(sell, smeta)
    rows = 32 * len(width)
    assert not count[rows:].any()          # rows past n hold nothing
    assert sm["entries"] == int(count.sum())
    # a slice is as wide as its longest row, and the rows are the slab's
    # kept lanes in slab order, then value 0 and column 0
    np.testing.assert_array_equal(width, count[:rows].reshape(-1, 32).max(1))
    wide = max(got_v.shape[1], want_v.shape[1])
    pad = [(0, 0), (0, 0)]
    for got, want in ((got_v, want_v[:rows]), (got_c, want_c[:rows])):
        pad[1] = (0, wide - got.shape[1])
        got = np.pad(got, pad)
        pad[1] = (0, wide - want.shape[1])
        np.testing.assert_array_equal(got, np.pad(want, pad))
    # built once at set-up, and deterministically
    _, again, again_meta = _stream(kind, layout)
    assert again_meta == smeta
    assert all(torch.equal(again[key], sell[key]) for key in spmv_sell.STREAM)


def test_compact_stream_drops_the_slab_padding():
    """The permuted stencil: the slab carries at least 3 times the kept
    entries, the compact stream at most 1.1 times."""
    d = tgen.permute_locally(tgen.stencil_3d(64, 32, 32, points=27))
    layout, tail, stats = spmv_packed.plan_packed_layout(d.canonical(),
                                                         d.values)
    assert stats["tail_nnz"] == 0
    _, sell, smeta = _stream("packed", layout)
    entries = dict(smeta)["entries"]
    assert entries == stats["ell_nnz"] == d.nnz
    assert layout["vals"].size / entries >= 3
    assert sell["sv"].numel() / entries <= 1.1


def _jax_csr_arrays(d):
    """The JAX package's packed Csr of ``d`` read out as numpy."""
    import ginkgo_tpu as gt
    A = gt.Csr.from_data(gt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                       d.values), strategy="packed")
    names = ("row_ptr", "col_idx", "values", "row_idx", "tail_rows",
             "tail_cols", "tail_vals", "pell_vals", "pell_idx", "pell_qw",
             "pell_xbase")
    arrays = {a: None if getattr(A, a) is None else np.asarray(getattr(A, a))
              for a in names}
    static = {s: getattr(A, s) for s in ("shape", "nnz", "strategy",
                                          "diag_offsets", "band_meta",
                                          "pell_meta")}
    return arrays, static


CSR_FIELDS = ("row_ptr", "col_idx", "values", "row_idx", "shape", "nnz",
              "strategy", "tail_rows", "tail_cols", "tail_vals", "pell_meta",
              "pell_vals", "pell_idx", "pell_qw", "pell_xbase")


@pytest.mark.parametrize("how", ["from_data", "csr_from_arrays",
                                 "constructor"])
def test_csr_builds_the_stream(how):
    d = _dense_row()
    if how == "csr_from_arrays":
        A = csr_from_arrays(*_jax_csr_arrays(d), device="cpu")
    else:
        A = gtt.Csr.from_data(d, strategy="packed", device="cpu")
    if how == "constructor":
        A = gtt.Csr(**{f: getattr(A, f) for f in CSR_FIELDS})
    assert A.strategy == "packed" and A.tail_rows is not None
    assert A.sell is not None and A.sell["sv"].device.type == "cpu"
    sell, smeta = spmv_sell.sell_from_packed(A.pell_vals, A.pell_idx,
                                             A.pell_qw, A.pell_xbase,
                                             A.pell_meta)
    assert A.sell_meta == smeta
    assert all(torch.equal(A.sell[key], sell[key]) for key in spmv_sell.STREAM)
    x = np.random.default_rng(3).standard_normal((d.shape[1], 2))
    want = d.canonical()
    dense = np.zeros(d.shape)
    np.add.at(dense, (want.row_idx, want.col_idx), want.values)
    _close(A.apply(torch.from_numpy(x)).numpy(), dense @ x, 1e-12)


def test_packed_csr_without_its_slab_raises():
    """A packed Csr given no slab has no stream: its apply raises rather
    than taking the plain gather."""
    A = gtt.Csr.from_data(_dense_row(), strategy="packed", device="cpu")
    fields = {f: getattr(A, f) for f in CSR_FIELDS
              if not f.startswith("pell_")}
    B = gtt.Csr(**fields)
    assert B.sell is None and B.sell_meta is None
    with pytest.raises(ValueError, match="planned slab"):
        B.apply(torch.ones((A.shape[1], 1), dtype=A.dtype))
