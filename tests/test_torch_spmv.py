"""The port's SpMV against ginkgo_tpu's on the same planned arrays.

- the plain versions of the banded and packed kernels against the JAX
  reference tier (``ops/spmv.py::dia_spmv``, ``pell_spmv_reference``) and
  the banded Pallas kernel in interpret mode;
- numpy emulations of the CUDA kernels' own index arithmetic (one thread
  per row, flat addresses, masked x reads) against the plain versions, so
  the address math of ``ops/csrc/*.cu`` is checked without a card; for
  ``sell_spmv.cu`` over the compact streams of both slabs it serves
  (kernels B and H);
- the whole ``Csr.apply``, COO tails included, against the JAX ``Csr``;
- the wrappers' dispatch: CPU tensors take the plain version, and the
  registry routes CUDA operands to the kernel wrappers.

Tolerances: f64 rtol 1e-12 and f32 rtol 1e-5 relative to the largest |y|
(the summation order differs between the two frameworks); bf16 storage is
widened to f32 on both sides, so it is held at the f32 tolerance.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.ops import spmv_packed as jpk
from ginkgo_tpu.ops.spmv import dia_spmv as jax_dia_spmv
from ginkgo_tpu.ops.spmv_pallas import dia_spmv_pallas
from ginkgo_tpu_torch.ops import registry, spmv_banded, spmv_packed, spmv_sell
from ginkgo_tpu_torch.ops.attic import spmv_chunked
from ginkgo_tpu_torch.utils import generators as tgen

RTOL = {np.float64: 1e-12, np.float32: 1e-5, "bf16": 1e-5}


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rtol)


def _banded(n, offsets, dtype, seed=0):
    """Random diagonals, zero where i + off leaves [0, n), blocked."""
    rng = np.random.default_rng(seed)
    dv = rng.standard_normal((len(offsets), n)).astype(dtype)
    for d, off in enumerate(offsets):
        if off < 0:
            dv[d, :-off] = 0
        elif off > 0:
            dv[d, n - off:] = 0
    meta = spmv_banded.plan_banded_layout(tuple(offsets), n)
    return meta, spmv_banded.block_diag_values(dv, meta)


BANDED_CASES = [(1000, (-1, 0, 1)),
                (3000, (-130, -129, -1, 0, 1, 128, 129, 130)),
                (2500, (-257, -16, 0, 16, 257)),
                (700, (0,))]


@pytest.mark.parametrize("n,offsets", BANDED_CASES)
@pytest.mark.parametrize("k", [1, 3, 9])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, "bf16"], ids=str)
def test_dia_plain_matches_jax(n, offsets, k, dtype):
    vdt = np.float32 if dtype == "bf16" else dtype
    meta, dvb = _banded(n, offsets, vdt, seed=n + k)
    x = np.random.default_rng(k).standard_normal((n, k)).astype(vdt)
    dvb_j, dvb_t = jnp.asarray(dvb), torch.from_numpy(dvb)
    if dtype == "bf16":
        dvb_j, dvb_t = dvb_j.astype(jnp.bfloat16), dvb_t.to(torch.bfloat16)
    want = jax_dia_spmv(offsets, dvb_j, meta, jnp.asarray(x))
    got = spmv_banded.dia_spmv_reference(offsets, dvb_t, meta,
                                         torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    _close(got.numpy(), want, RTOL[dtype])


def test_dia_plain_matches_pallas_interpret():
    n, offsets = 2000, (-129, -1, 0, 1, 129)
    meta, dvb = _banded(n, offsets, np.float32, seed=3)
    x = np.random.default_rng(4).standard_normal((n, 3)).astype(np.float32)
    want = dia_spmv_pallas(offsets, jnp.asarray(dvb), meta, jnp.asarray(x),
                           interpret=True)
    got = spmv_banded.dia_spmv_reference(offsets, torch.from_numpy(dvb),
                                         meta, torch.from_numpy(x))
    _close(got.numpy(), want, 1e-5)


def emulate_dia_kernel(offsets, dvb, meta, x):
    """csrc/dia_spmv.cu's arithmetic in numpy: thread i reads
    dvb.flat[((g*D + d)*S + s)*128 + l] and x[i + off] where in range."""
    G, D, S, _ = dvb.shape
    n = meta["n"]
    i = np.arange(n)
    sg = i >> 7
    g, s = sg // S, sg % S
    flat = dvb.reshape(-1)
    y = np.zeros((n, x.shape[1]), np.float64)
    for d, off in enumerate(offsets):
        w = flat[((g * D + d) * S + s) * 128 + (i & 127)].astype(np.float64)
        j = i + off
        ok = (j >= 0) & (j < n)
        y[ok] += w[ok, None] * x[j[ok]]
    return y


@pytest.mark.parametrize("n,offsets", BANDED_CASES)
def test_dia_kernel_index_math(n, offsets):
    meta, dvb = _banded(n, offsets, np.float64, seed=7)
    x = np.random.default_rng(8).standard_normal((n, 2))
    want = spmv_banded.dia_spmv_reference(offsets, torch.from_numpy(dvb),
                                          meta, torch.from_numpy(x))
    _close(emulate_dia_kernel(offsets, dvb, meta, x), want.numpy(), 1e-12)


def _wide_run():
    """kWideRun of csrc/dia_spmv.cu: the rows a thread of the wide instance
    walks."""
    src = (Path(spmv_banded.__file__).parent / "csrc" / "dia_spmv.cu"
           ).read_text()
    return int(re.search(r"constexpr int kWideRun = (\d+);", src).group(1))


def emulate_dia_wide_kernel(offsets, dvb, meta, x, run):
    """The wide instance of csrc/dia_spmv.cu in numpy: the thread of slot t
    walks rows t*run .. t*run + run - 1 (inside one 128-row group), reads
    their band values from one run of dvb, and keeps x[i + off] of its rows
    in a window that slides by one row when an offset is one above the
    last; window rows it never read are NaN, so a stale one shows."""
    G, D, S, _ = dvb.shape
    n = meta["n"]
    i = np.arange(-(-n // run))[:, None] * run + np.arange(run)
    sg = i >> 7
    assert (sg == sg[:, :1]).all()
    g, s = sg // S, sg % S
    flat = dvb.reshape(-1)
    acc = np.zeros(i.shape + x.shape[1:], x.dtype)
    win = np.full_like(acc, np.nan)
    prev = None
    for d, off in enumerate(offsets):
        w = flat[((g * D + d) * S + s) * 128 + (i & 127)].astype(x.dtype)
        j = i + off
        ok = (j >= 0) & (j < n)
        if prev is not None and off == prev + 1:
            win[:, :-1] = win[:, 1:]
            last = ok[:, -1]
            win[last, -1] = x[j[last, -1]]
        else:
            win[ok] = x[j[ok]]
        prev = off
        acc[ok] += w[ok][:, None] * win[ok]
    return acc.reshape(-1, x.shape[1])[:n]


@pytest.mark.parametrize("n,offsets", BANDED_CASES)
@pytest.mark.parametrize("k", [2, 16])
def test_dia_wide_kernel_index_math(n, offsets, k):
    """The wide instance's row runs and sliding window give the narrow
    instance's sums bit for bit (f64, the same order), and the plain
    version's to rounding in f32."""
    run = _wide_run()
    assert run >= 1 and 128 % run == 0
    meta, dvb = _banded(n, offsets, np.float64, seed=9)
    x = np.random.default_rng(10).standard_normal((n, k))
    got = emulate_dia_wide_kernel(offsets, dvb, meta, x, run)
    assert np.array_equal(got, emulate_dia_kernel(offsets, dvb, meta, x))
    x32, dvb32 = x.astype(np.float32), dvb.astype(np.float32)
    want = spmv_banded.dia_spmv_reference(offsets, torch.from_numpy(dvb32),
                                          meta, torch.from_numpy(x32))
    _close(emulate_dia_wide_kernel(offsets, dvb32, meta, x32, run),
           want.numpy(), 1e-5)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 8, 9, 16, 17, 32, 33])
@pytest.mark.parametrize("is_complex", [False, True])
def test_dia_kernel_instance_routing(k, is_complex):
    """One real column takes the narrow instance; two or more the wide one,
    16 columns a launch; complex operands the complex instantiation, 8 a
    launch.  The launches cover the columns once, in order."""
    instance = spmv_banded.kernel_instance(k, is_complex)
    assert instance == ("complex" if is_complex else
                        "narrow" if k == 1 else "wide")
    width = {"complex": spmv_banded.MAX_RHS, "narrow": 1,
             "wide": spmv_banded.WIDE_RHS}[instance]
    assert (spmv_banded.MAX_RHS, spmv_banded.WIDE_RHS) == (8, 16)
    chunks = spmv_banded.column_chunks(k, width)
    assert len(chunks) == -(-k // width)
    assert [c for c0, cols in chunks for c in range(c0, c0 + cols)] == \
        list(range(k))
    assert all(1 <= cols <= width for _, cols in chunks)


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
    return gtt.MatrixData((n, n), rows, cols, vals)


def _packed_layout(name):
    if name == "fem_like":
        d = _fem_like(2000, seed=1).canonical()
    elif name == "permuted":
        d = tgen.permute_locally(tgen.stencil_3d(16, 16, 8, points=27))
    else:                                   # rectangular, ragged rows
        d = tgen.generate_random_matrix(1100, 900, nonzeros_per_row=(1, 9),
                                        seed=3)
        # keep columns local so the packed window accepts every row
        d = gtt.MatrixData(d.shape, d.row_idx,
                           np.minimum(d.row_idx * 900 // 1100
                                      + d.col_idx % 40, 899),
                           d.values).canonical()
    layout, tail, _ = spmv_packed.plan_packed_layout(d, d.values)
    assert layout is not None
    return d, layout


@pytest.mark.parametrize("name", ["fem_like", "permuted", "rect"])
@pytest.mark.parametrize("k", [1, 3, 9])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, "bf16"], ids=str)
def test_pell_plain_matches_jax(name, k, dtype):
    d, layout = _packed_layout(name)
    vdt = np.float32 if dtype == "bf16" else dtype
    vals = layout["vals"].astype(vdt)
    x = np.random.default_rng(k).standard_normal((d.shape[1], k)).astype(vdt)
    ints = ("idx", "qw", "xbase_row")
    vals_j, vals_t = jnp.asarray(vals), torch.from_numpy(vals)
    if dtype == "bf16":
        vals_j, vals_t = vals_j.astype(jnp.bfloat16), vals_t.to(torch.bfloat16)
    want = jpk.pell_spmv_reference(vals_j, *(jnp.asarray(layout[a])
                                             for a in ints),
                                   layout["meta"], jnp.asarray(x))
    got = spmv_packed.pell_spmv_reference(
        vals_t, *(torch.from_numpy(layout[a]) for a in ints),
        layout["meta"], torch.from_numpy(x))
    assert got.shape == (d.shape[0], k)
    _close(got.numpy(), want, RTOL[dtype])


def emulate_sell_kernel(sell, meta_items, x):
    """csrc/sell_spmv.cu's arithmetic in numpy: thread r of slice
    s = r >> 5 and lane r & 31 walks j < width(s), reads stream entry
    sp[s] + 32 j + lane, takes column 128 * xbase[s >> 5] + sc, and gathers
    x[col] for col < m (no padded copy of x)."""
    meta = dict(meta_items)
    n, m, n_slices = meta["n"], meta["m"], meta["n_slices"]
    sv = sell["sv"].double().numpy()
    sc = sell["sc"].numpy().astype(np.int64)
    sp = sell["sp"].numpy()
    xbase = sell["xbase"].numpy().astype(np.int64)
    r = np.arange(n_slices * 32)
    s = r >> 5
    width = (sp[s + 1] - sp[s]) >> 5
    base = 128 * xbase[s >> 5]
    y = np.zeros((r.size, x.shape[1]), np.float64)
    for j in range(int(width.max())):
        live = j < width
        e = np.where(live, sp[s] + 32 * j + (r & 31), 0)
        col = base + sc[e]
        ok = live & (col < m)
        y[ok] += sv[e][ok, None] * x[col[ok]]
    return y[:n]


def _torch_layout(layout, names):
    return [torch.from_numpy(layout[a]) for a in names]


@pytest.mark.parametrize("name", ["fem_like", "permuted", "rect"])
def test_pell_kernel_index_math(name):
    """Kernel B's thread walk over the slab's compact stream against the
    slab's own plain version."""
    d, layout = _packed_layout(name)
    x = np.random.default_rng(9).standard_normal((d.shape[1], 2))
    arrays = _torch_layout(layout, ("vals", "idx", "qw", "xbase_row"))
    want = spmv_packed.pell_spmv_reference(*arrays, layout["meta"],
                                           torch.from_numpy(x))
    sell, smeta = spmv_sell.sell_from_packed(*arrays, layout["meta"])
    _close(emulate_sell_kernel(sell, smeta, x), want.numpy(), 1e-12)


@pytest.mark.parametrize("capped", [False, True], ids=["", "capped"])
@pytest.mark.parametrize("name", ["fem_like", "permuted", "rect"])
def test_cell_kernel_index_math(name, capped):
    """Kernel H's thread walk over the chunk-ELL slab's compact stream
    against the slab's own plain version, with (capped) and without a
    COO tail."""
    d, _ = _packed_layout(name)
    layout, tail, _ = spmv_chunked.plan_chunked_layout(
        d, d.values, **({"wv_cap": 2} if capped else {}))
    assert (len(tail[0]) > 0) == capped
    x = np.random.default_rng(10).standard_normal((d.shape[1], 3))
    arrays = _torch_layout(layout, spmv_chunked.ARRAYS)
    want = spmv_chunked.cell_spmv_reference(*arrays, layout["meta"],
                                            torch.from_numpy(x))
    sell, smeta = spmv_sell.sell_from_chunked(*arrays, layout["meta"])
    _close(emulate_sell_kernel(sell, smeta, x), want.numpy(), 1e-12)


def _dense_row_case():
    """fem_like plus one full row: the packed slot budget overflows, so
    an explicit ``packed`` plan spills that row to a COO tail."""
    d = _fem_like(2048, seed=2)
    n = d.shape[0]
    rows = np.concatenate([d.row_idx, np.full(n, 5)])
    cols = np.concatenate([d.col_idx, np.arange(n)])
    vals = np.concatenate([d.values, np.linspace(-1, 1, n)])
    return gtt.MatrixData((n, n), rows, cols, vals)


def _stencil_tail_case():
    d = tgen.stencil_3d(10, points=27)
    rng = np.random.default_rng(5)
    r = rng.integers(0, d.shape[0], 20)
    return gtt.MatrixData(d.shape, np.concatenate([d.row_idx, r]),
                          np.concatenate([d.col_idx,
                                          (r + d.shape[0] // 2)
                                          % d.shape[0]]),
                          np.concatenate([d.values,
                                          rng.standard_normal(20)]))


CSR_CASES = {
    "banded": (lambda: tgen.stencil_3d(9, points=27), "automatical",
               "banded", False),
    "banded_tail": (_stencil_tail_case, "automatical", "banded", True),
    "packed": (lambda: tgen.permute_locally(
        tgen.stencil_3d(16, 8, 8, points=27)), "automatical", "packed",
        False),
    "packed_tail": (_dense_row_case, "packed", "packed", True),
    "classical": (lambda: tgen.generate_random_matrix(
        800, 800, nonzeros_per_row=(1, 10), seed=6), "automatical",
        "classical", False),
}


@pytest.mark.parametrize("case", sorted(CSR_CASES))
@pytest.mark.parametrize("k", [1, 3, 9])
def test_csr_apply_matches_jax(case, k):
    make, strategy, expect, has_tail = CSR_CASES[case]
    d = make()
    At = gtt.Csr.from_data(d, strategy=strategy, device="cpu")
    Aj = gt.Csr.from_data(gt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                        d.values), strategy=strategy)
    assert At.strategy == Aj.strategy == expect
    assert (At.tail_rows is not None) == has_tail
    x = np.random.default_rng(k).standard_normal((d.shape[1], k))
    want = np.asarray(Aj.apply(jnp.asarray(x)))
    got = At.apply(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-12)
    x1 = torch.from_numpy(x[:, 0].copy())
    assert At.apply(x1).shape == (d.shape[0],)


def test_cpu_tensors_take_plain_versions():
    """The CUDA wrappers run the plain version on CPU tensors, and only
    there; their launch counters stay put."""
    n, offsets = 1500, (-40, -1, 0, 1, 40)
    meta, dvb = _banded(n, offsets, np.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, 2)).astype(np.float32))
    before = spmv_banded.dia_spmv_cuda.launches
    got = spmv_banded.dia_spmv_cuda(offsets, torch.from_numpy(dvb), meta, x)
    want = spmv_banded.dia_spmv_reference(offsets, torch.from_numpy(dvb),
                                          meta, x)
    assert torch.equal(got, want)
    assert spmv_banded.dia_spmv_cuda.launches == before
    d, layout = _packed_layout("permuted")
    sell, smeta = spmv_sell.sell_from_packed(
        *_torch_layout(layout, ("vals", "idx", "qw", "xbase_row")),
        layout["meta"])
    xb = torch.ones((d.shape[1], 1), dtype=torch.float64)
    before = spmv_packed.pell_spmv_cuda.launches
    assert torch.equal(spmv_packed.pell_spmv_cuda(sell, smeta, xb),
                       spmv_sell.sell_spmv_reference(sell, smeta, xb))
    assert spmv_packed.pell_spmv_cuda.launches == before


def test_registry_routes_by_device():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert registry.lookup("dia_spmv", cuda) is spmv_banded.dia_spmv_cuda
    assert registry.lookup("pell_spmv", cuda) is spmv_packed.pell_spmv_cuda
    assert registry.lookup("dia_spmv", cpu) is \
        spmv_banded.dia_spmv_reference
    # the packed op runs over the compact stream: its plain version is
    # the stream's
    assert registry.lookup("pell_spmv", cpu) is \
        spmv_sell.sell_spmv_reference
    # no cuda tier: the plain version runs on the card too
    from ginkgo_tpu_torch.ops.spmv import coo_spmv
    assert registry.lookup("coo_spmv", cuda) is coo_spmv
    with registry.use_tier("reference"):
        assert registry.lookup("dia_spmv", cuda) is \
            spmv_banded.dia_spmv_reference
    assert registry.current_tier(cuda) == "cuda"
    with pytest.raises(KeyError):
        registry.lookup("no_such_kernel", cpu)


def test_coo_spmv_drops_padding_rows():
    from ginkgo_tpu_torch.ops.spmv import coo_spmv
    rows = torch.tensor([0, 2, 2, 3, 3], dtype=torch.int32)   # 3 == n: pad
    cols = torch.tensor([1, 0, 2, 0, 0], dtype=torch.int32)
    vals = torch.tensor([2.0, 3.0, 4.0, 0.0, 9.0], dtype=torch.float64)
    x = torch.tensor([[1.0], [10.0], [100.0]], dtype=torch.float64)
    y = coo_spmv(rows, cols, vals, x, 3)
    assert y[:, 0].tolist() == [20.0, 0.0, 403.0]
