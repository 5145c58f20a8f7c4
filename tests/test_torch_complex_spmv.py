"""Complex SpMV of the port against ginkgo_tpu's complex entry points.

- the port's banded and packed SpMV on CPU tensors (the plain versions the
  wrappers take there) against ``dia_spmv_complex`` and
  ``pell_spmv_complex`` with the Pallas kernels in interpret mode, for a
  complex64 matrix and vector, a real f32 matrix with a complex64 vector
  and a complex64 matrix with a real f32 vector (cast to complex64 first,
  as ``dia_spmv_tpu`` does);
- numpy emulations of the complex instantiations of ``csrc/dia_spmv.cu``
  and ``csrc/sell_spmv.cu`` (each entry one complex multiply-add in f32
  parts, in the kernels' order) against the same;
- a complex ``Csr.apply`` on both layouts against the JAX ``Csr.apply``;
- the compact stream of a complex slab keeps an entry whose real part is 0.

Tolerance: 1e-5 relative to the largest |y| in complex64 (the TPU sums
sum a_re x - sum a_im x over two real passes, the kernels one fused complex
multiply-add an entry: the same terms in another order), 1e-12 in
complex128.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.ops.spmv_packed import pell_spmv_complex
from ginkgo_tpu.ops.spmv_pallas import dia_spmv_complex
from ginkgo_tpu_torch.ops import spmv_banded, spmv_packed, spmv_sell
from ginkgo_tpu_torch.utils import generators as tgen

TYPES = {"c64": np.complex64, "f32": np.float32}
# (values, vector) pairs; k = 9 takes two launches on the card and three
# chunks of the TPU's doubled columns
PAIRS = [("c64", "c64", 1), ("c64", "c64", 9), ("f32", "c64", 3),
         ("c64", "f32", 3)]


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) / scale <= rtol


def _complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _cast(a, name):
    return (a if name == "c64" else a.real).astype(TYPES[name])


@pytest.fixture(scope="module")
def banded():
    n, offsets = 2000, (-129, -1, 0, 1, 129)
    rng = np.random.default_rng(5)
    dv = _complex(rng, (len(offsets), n))
    for d, off in enumerate(offsets):
        if off < 0:
            dv[d, :-off] = 0
        elif off > 0:
            dv[d, n - off:] = 0
    meta = spmv_banded.plan_banded_layout(offsets, n)
    return offsets, meta, spmv_banded.block_diag_values(dv, meta)


@pytest.fixture(scope="module")
def packed():
    """A one-superblock permuted stencil with complex values, some purely
    imaginary, and its planned slab."""
    d = tgen.permute_locally(tgen.stencil_3d(16, 8, 8, points=27))
    rng = np.random.default_rng(6)
    vals = _complex(rng, d.nnz)
    vals[::3] = 1j * vals[::3].imag
    d = gtt.MatrixData(d.shape, d.row_idx, d.col_idx, vals)
    layout, tail, _ = spmv_packed.plan_packed_layout(d, d.values)
    assert layout is not None and len(tail[0]) == 0
    return d, layout


def emulate_complex_dia(offsets, dvb, meta, x):
    """The complex instantiation of csrc/dia_spmv.cu in numpy: thread i
    walks the diagonals in order, one complex multiply-add in f32 parts a
    diagonal (a real value scales both parts)."""
    G, D, S, _ = dvb.shape
    n = meta["n"]
    i = np.arange(n)
    sg = i >> 7
    g, s = sg // S, sg % S
    flat = dvb.reshape(-1)
    y_re = np.zeros((n, x.shape[1]), np.float32)
    y_im = np.zeros_like(y_re)
    for d, off in enumerate(offsets):
        w = flat[((g * D + d) * S + s) * 128 + (i & 127)]
        j = i + off
        ok = (j >= 0) & (j < n)
        y_re[ok], y_im[ok] = _madd(y_re[ok], y_im[ok], w[ok], x[j[ok]])
    return y_re + 1j * y_im


def emulate_complex_sell(sell, meta_items, x):
    """The complex instantiation of csrc/sell_spmv.cu in numpy: thread r
    of slice r >> 5 walks its stream entries in order, one complex
    multiply-add in f32 parts an entry."""
    meta = dict(meta_items)
    n, m, n_slices = meta["n"], meta["m"], meta["n_slices"]
    sv = sell["sv"].numpy()
    sc = sell["sc"].numpy().astype(np.int64)
    sp = sell["sp"].numpy()
    xbase = sell["xbase"].numpy().astype(np.int64)
    r = np.arange(n_slices * 32)
    s = r >> 5
    width = (sp[s + 1] - sp[s]) >> 5
    base = 128 * xbase[s >> 5]
    y_re = np.zeros((r.size, x.shape[1]), np.float32)
    y_im = np.zeros_like(y_re)
    for j in range(int(width.max())):
        live = j < width
        e = np.where(live, sp[s] + 32 * j + (r & 31), 0)
        col = base + sc[e]
        ok = live & (col < m)
        y_re[ok], y_im[ok] = _madd(y_re[ok], y_im[ok], sv[e][ok], x[col[ok]])
    return (y_re + 1j * y_im)[:n]


def _madd(y_re, y_im, w, x):
    """y += w x per row, in f32 parts: the kernels' ``madd``."""
    w = w[:, None]
    w_re = np.real(w).astype(np.float32)
    w_im = np.imag(w).astype(np.float32)
    x_re, x_im = x.real.astype(np.float32), x.imag.astype(np.float32)
    return (y_re + (w_re * x_re - w_im * x_im),
            y_im + (w_re * x_im + w_im * x_re))


@pytest.mark.parametrize("vtype,xtype,k", PAIRS)
def test_banded_complex_matches_pallas_interpret(banded, vtype, xtype, k):
    offsets, meta, dvb = banded
    dvb = _cast(dvb, vtype)
    x = _cast(_complex(np.random.default_rng(k), (meta["n"], k)), xtype)
    want = np.asarray(dia_spmv_complex(offsets, jnp.asarray(dvb), meta,
                                       jnp.asarray(x), interpret=True))
    got = spmv_banded.dia_spmv_cuda(offsets, torch.from_numpy(dvb), meta,
                                    torch.from_numpy(x))
    assert got.dtype == torch.complex64 and want.dtype == np.complex64
    _close(got.numpy(), want, 1e-5)
    xc = x.astype(np.complex64)
    _close(emulate_complex_dia(offsets, dvb, meta, xc), want, 1e-5)


@pytest.mark.parametrize("vtype,xtype,k", PAIRS)
def test_packed_complex_matches_pallas_interpret(packed, vtype, xtype, k):
    d, layout = packed
    vals = _cast(layout["vals"], vtype)
    ints = [layout[a] for a in ("idx", "qw", "xbase_row")]
    x = _cast(_complex(np.random.default_rng(k), (d.shape[1], k)), xtype)
    want = np.asarray(pell_spmv_complex(
        jnp.asarray(vals), *map(jnp.asarray, ints), layout["meta"],
        jnp.asarray(x), interpret=True))
    sell, smeta = spmv_sell.sell_from_packed(
        torch.from_numpy(vals), *map(torch.from_numpy, ints), layout["meta"])
    got = spmv_packed.pell_spmv_cuda(sell, smeta, torch.from_numpy(x))
    assert got.dtype == torch.complex64 and want.dtype == np.complex64
    _close(got.numpy(), want, 1e-5)
    _close(emulate_complex_sell(sell, smeta, x.astype(np.complex64)), want,
           1e-5)


def test_compact_stream_keeps_imaginary_entries(packed):
    """One nonzero mask over both parts: an entry whose real part is 0
    stays in the stream, and the stream gives the slab's product."""
    d, layout = packed
    assert np.count_nonzero(d.values.real == 0) >= d.nnz // 3
    arrays = [torch.from_numpy(layout[a])
              for a in ("vals", "idx", "qw", "xbase_row")]
    sell, smeta = spmv_sell.sell_from_packed(*arrays, layout["meta"])
    assert dict(smeta)["entries"] == d.nnz
    assert int((sell["sv"] != 0).sum()) == d.nnz
    x = torch.from_numpy(_complex(np.random.default_rng(1), (d.shape[1], 2)))
    _close(spmv_sell.sell_spmv_reference(sell, smeta, x).numpy(),
           spmv_packed.pell_spmv_reference(*arrays, layout["meta"],
                                           x).numpy(), 1e-12)
    _close(spmv_sell.sell_spmv_reference(sell, smeta, x).numpy(),
           d.to_dense() @ x.numpy(), 1e-12)


def _shifted_stencil(points, dims):
    """The complex model problem of the card's banded phase at a small
    size: the stencil P, A = P (1 + 0.02i) + 0.5i I."""
    d = tgen.stencil_3d(*dims, points=points)
    vals = d.values * (1 + 0.02j) + 0.5j * (d.row_idx == d.col_idx)
    return gtt.MatrixData(d.shape, d.row_idx, d.col_idx, vals)


CSR_CASES = {"banded": lambda: _shifted_stencil(27, (9, 9, 9)),
             "packed": lambda: tgen.permute_locally(
                 _shifted_stencil(27, (16, 8, 8)))}


@pytest.mark.parametrize("dtype,rtol", [(np.complex64, 1e-5),
                                        (np.complex128, 1e-12)])
@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_complex_csr_apply_matches_jax(case, dtype, rtol):
    d = CSR_CASES[case]()
    At = gtt.Csr.from_data(d, dtype=dtype, device="cpu")
    Aj = gt.Csr.from_data(gt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                        d.values), dtype=dtype)
    assert At.strategy == Aj.strategy == case
    assert At.dtype == getattr(torch, np.dtype(dtype).name)
    x = _complex(np.random.default_rng(2), (d.shape[1], 3)).astype(dtype)
    want = np.asarray(Aj.apply(jnp.asarray(x)))
    got = At.apply(torch.from_numpy(x))
    assert got.dtype == At.dtype
    _close(got.numpy(), want, rtol)


def test_complex_dispatch_on_the_cpu(banded):
    """CPU tensors take the plain versions and launch nothing; a complex64
    matrix casts a real f32 vector to complex64 first."""
    offsets, meta, dvb = banded
    dvb = torch.from_numpy(dvb.astype(np.complex64))
    x = torch.ones((meta["n"], 1), dtype=torch.float32)
    before = (spmv_banded.dia_spmv_cuda.launches,
              spmv_banded.dia_spmv_complex_cuda.launches)
    y = spmv_banded.dia_spmv_complex_cuda(offsets, dvb, meta, x)
    assert y.dtype == torch.complex64
    assert torch.equal(y, spmv_banded.dia_spmv_reference(
        offsets, dvb, meta, x.to(torch.complex64)))
    assert (spmv_banded.dia_spmv_cuda.launches,
            spmv_banded.dia_spmv_complex_cuda.launches) == before
    assert spmv_banded.kernel_vector(torch.complex64, x).dtype == \
        torch.complex64
    for vdtype, xdtype in ((torch.complex128, torch.float64),
                           (torch.complex64, torch.float64),
                           (torch.float32, torch.complex64)):
        assert spmv_banded.kernel_vector(vdtype, x.to(xdtype)).dtype == xdtype
