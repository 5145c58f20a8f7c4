"""Matrix Market and Ginkgo binary I/O of the port against ginkgo_tpu's.

Text files in every field (real, integer, complex, pattern) and symmetry
(general, symmetric, skew-symmetric, hermitian), coordinate and array,
read by both packages through the native reader (a path), the Python
reader (a stream or a string) and ``build_matrix_data``'s ``filename``
case: the MatrixData must be equal exactly.  Files written by either
package must be equal byte for byte and read back by the other, binary
files in every value and index type the format names, bf16 included.
"""

import io

import ml_dtypes
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.base import mtx_io as jio
from ginkgo_tpu.benchmark.runner import build_matrix_data as jbuild
from ginkgo_tpu_torch import native
from ginkgo_tpu_torch.base import mtx_io as tio
from ginkgo_tpu_torch.base.matrix_data import MatrixData
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.utils import generators as tgen

FILES = {
    "real-general": "%%MatrixMarket matrix coordinate real general\n"
                    "% a comment\n3 4 5\n1 1 2.5\n3 4 -1e-3\n2 2 7\n"
                    "1 3 0.125\n3 1 4\n",
    "integer-general": "%%MatrixMarket matrix coordinate integer general\n"
                       "2 3 3\n1 2 5\n2 3 -7\n2 1 1\n",
    "complex-general": "%%MatrixMarket matrix coordinate complex general\n"
                       "2 2 3\n1 1 1.5 -0.5\n2 2 2.0 1.0\n1 2 0 3\n",
    "pattern-general": "%%MatrixMarket matrix coordinate pattern general\n"
                       "3 3 4\n1 2\n2 1\n3 3\n1 1\n",
    "real-symmetric": "%%MatrixMarket matrix coordinate real symmetric\n"
                      "3 3 4\n1 1 2.0\n2 1 -1.0\n2 2 2.0\n3 2 -0.5\n",
    "real-skew": "%%MatrixMarket matrix coordinate real skew-symmetric\n"
                 "3 3 2\n2 1 1.5\n3 1 -2.0\n",
    "complex-hermitian": "%%MatrixMarket matrix coordinate complex "
                         "hermitian\n2 2 3\n1 1 4 0\n2 1 1 2\n2 2 3 0\n",
    "pattern-symmetric": "%%MatrixMarket matrix coordinate pattern "
                         "symmetric\n3 3 3\n1 1\n3 1\n3 2\n",
    "real-array": "%%MatrixMarket matrix array real general\n2 3\n"
                  "1\n2\n0\n4\n5.5\n-6\n",
    "complex-array": "%%MatrixMarket matrix array complex general\n2 1\n"
                     "1 2\n3 -4\n",
}


def assert_same(dt, dj, types=True):
    """Equal entries (and, with ``types``, equal array types)."""
    assert tuple(dt.shape) == tuple(dj.shape)
    for name in ("row_idx", "col_idx", "values"):
        a, b = getattr(dt, name), np.asarray(getattr(dj, name))
        assert np.array_equal(a, b), name
        assert a.dtype == b.dtype or not types, name


def jdata(d):
    return gt.MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


@pytest.fixture(scope="module")
def lib():
    if native.lib() is None:
        pytest.skip("needs a C++ compiler for the native reader")
    return native.lib()


@pytest.mark.parametrize("name", sorted(FILES))
def test_read_matches_jax(name, tmp_path, lib):
    text = FILES[name]
    path = tmp_path / f"{name}.mtx"
    path.write_text(text)
    want = jio.read_mtx(str(path))
    for got in (tio.read_mtx(str(path)), tio.read_mtx(text),
                tio.read_mtx(text.encode()), tio.read_mtx(io.StringIO(text)),
                build_matrix_data({"filename": str(path)})):
        assert_same(got.canonical(), want.canonical())
    assert_same(tio.read_mtx(str(path)), want)


@pytest.mark.parametrize("name", sorted(n for n in FILES if "array" not in n))
def test_native_reader_matches_python_reader(name, tmp_path, lib):
    path = tmp_path / f"{name}.mtx"
    path.write_text(FILES[name])
    shape, rows, cols, vals, symmetry = native.read_mtx_native(str(path))
    with open(path) as f:
        py = tio.read_mtx(f)
    assert_same(tio._assemble(shape, rows, cols, vals, symmetry), py)
    assert symmetry == FILES[name].split()[4]


def test_native_reader_declines_array_and_missing_files(tmp_path, lib):
    path = tmp_path / "a.mtx"
    path.write_text(FILES["real-array"])
    assert native.read_mtx_native(str(path)) is None
    assert native.read_mtx_native(str(tmp_path / "none.mtx")) is None


@pytest.mark.parametrize("text,match", [
    ("%%NotMatrixMarket\n1 1 1\n", "header"),
    ("%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1\n",
     "truncated|body"),
    ("%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1\n",
     "outside|body"),
])
def test_corrupt_files_raise_on_both_paths(text, match, tmp_path, lib):
    path = tmp_path / "bad.mtx"
    path.write_text(text)
    with pytest.raises(ValueError, match=match):
        tio.read_mtx(str(path))
    with pytest.raises(ValueError):
        jio.read_mtx(str(path))
    if "NotMatrixMarket" in text:
        with pytest.raises(ValueError, match="header"):
            tio.read_mtx(text)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["real", "complex"])
def test_written_text_is_the_jax_text(dtype, tmp_path, lib):
    d = tgen.generate_random_matrix(40, 31, nonzeros_per_row=(1, 6), seed=3,
                                    dtype=dtype)
    pt, pj = tmp_path / "t.mtx", tmp_path / "j.mtx"
    tio.write_mtx(str(pt), d)
    jio.write_mtx(str(pj), jdata(d))
    assert pt.read_bytes() == pj.read_bytes()
    # each package reads the other's file back to the written entries
    assert_same(tio.read_mtx(str(pj)), d.sort_row_major())
    assert_same(jio.read_mtx(str(pt)), jio.read_mtx(str(pj)))
    buf = io.StringIO()
    tio.write_mtx(buf, d)
    assert buf.getvalue().encode() == pj.read_bytes()


def test_write_accepts_operators_tensors_and_arrays(tmp_path):
    dense = np.array([[1.0, 0.0], [2.0, 3.0]])
    for src in (gtt.Csr.from_dense(dense, device="cpu"),
                gtt.Dense.create(dense, device="cpu"),
                gtt.Ell.from_data(MatrixData.from_dense(dense),
                                  device="cpu"),
                torch.from_numpy(dense), dense):
        path = str(tmp_path / "m.mtx")
        tio.write_mtx(path, src)
        np.testing.assert_array_equal(tio.read_mtx(path).to_dense(), dense)


def test_generated_case_round_trips_exactly(tmp_path, lib):
    """``%.17g`` keeps every f64 bit: the FEM case comes back equal, on
    the native path and through ``build_matrix_data``, in both
    packages."""
    case = {"fem": 3000, "offscale": 1.2}
    d = build_matrix_data(case)
    path = str(tmp_path / "fem.mtx")
    tio.write_mtx(path, d)
    assert_same(tio.read_mtx(path), d, types=False)
    assert_same(build_matrix_data({"filename": path}), d, types=False)
    assert_same(build_matrix_data({"filename": path}),
                jbuild({"filename": path}))


BINARY_TYPES = [(np.float64, "int64"), (np.float32, "int32"),
                (np.complex128, "int64"), (np.complex64, "int32"),
                (np.float16, "int32"), (np.float64, "int32"),
                (np.float32, "int64")]


@pytest.mark.parametrize("vdtype,idx", BINARY_TYPES,
                         ids=[f"{np.dtype(v).name}-{i}"
                              for v, i in BINARY_TYPES])
def test_binary_matches_jax_byte_for_byte(vdtype, idx, tmp_path):
    d = tgen.generate_random_matrix(23, 17, nonzeros_per_row=(1, 5), seed=4,
                                    dtype=np.complex128
                                    if np.dtype(vdtype).kind == "c"
                                    else np.float64).astype(vdtype)
    pt, pj = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    tio.write_binary(pt, d, index_dtype=idx)
    jio.write_binary(pj, jdata(d), index_dtype=idx)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    back = tio.read_binary(pj)
    assert_same(back, jio.read_binary(pt))
    assert np.array_equal(back.values, d.sort_row_major().values)


def test_binary_bf16_matches_jax(tmp_path):
    vals = np.array([1.5, -0.5, 3.14159, 1e-3, -65504.0, 0.1])
    d = MatrixData((3, 3), np.array([0, 0, 1, 1, 2, 2]),
                   np.array([0, 2, 1, 2, 0, 2]), vals)
    pt, pj = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    tio.write_binary(pt, d, value_dtype="bfloat16")
    jio.write_binary(pj, gt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                       vals.astype(ml_dtypes.bfloat16)))
    assert open(pt, "rb").read() == open(pj, "rb").read()
    assert open(pt, "rb").read()[6:8] == b"BL"
    pt2 = str(tmp_path / "t2.bin")
    tio.write_binary(pt2, d, value_dtype=torch.bfloat16)
    assert open(pt2, "rb").read() == open(pt, "rb").read()
    back = tio.read_binary(pj)
    assert back.values.dtype == np.float32
    want = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
    assert np.array_equal(back.values, want)
    assert np.array_equal(np.asarray(jio.read_binary(pt).values,
                                     np.float32), want)


def test_binary_header_bytes_and_errors(tmp_path):
    import struct
    d = MatrixData((3, 4), np.array([0, 1, 2]), np.array([1, 0, 3]),
                   np.array([1.5, -2.0, 0.25]))
    path = str(tmp_path / "m.bin")
    tio.write_binary(path, d)
    raw = open(path, "rb").read()
    assert raw[:8] == b"GINKGODL"
    assert struct.unpack("<QQQ", raw[8:32]) == (3, 4, 3)
    assert struct.unpack("<qqd", raw[32:56]) == (0, 1, 1.5)
    with open(path, "wb") as f:
        f.write(raw[:-4])
    with pytest.raises(ValueError, match="truncated"):
        tio.read_binary(path)
    with open(path, "wb") as f:
        f.write(b"GINKGOQL" + raw[8:])
    with pytest.raises(ValueError, match="type tag"):
        tio.read_binary(path)
    with pytest.raises(ValueError, match="value type"):
        tio.write_binary(path, d.astype(np.int8))
    with pytest.raises(ValueError, match="index type"):
        tio.write_binary(path, d, index_dtype="int16")
    big = MatrixData((3, 2**31 + 5), np.array([0]), np.array([2**31 + 1]),
                     np.array([1.0]))
    with pytest.raises(ValueError, match="int64"):
        tio.write_binary(path, big, index_dtype="int32")


def test_legacy_npz_reads(tmp_path):
    pz = str(tmp_path / "legacy.bin")
    with open(pz, "wb") as f:
        np.savez(f, shape=np.asarray([2, 2], np.int64),
                 row_idx=np.array([0, 1]), col_idx=np.array([1, 0]),
                 values=np.array([3.0, 4.0]))
    assert_same(tio.read_binary(pz), jio.read_binary(pz))
    np.testing.assert_array_equal(tio.read_binary(pz).to_dense(),
                                  [[0, 3], [4, 0]])


def test_package_exports_the_io_names():
    assert gtt.read_mtx is tio.read_mtx and gtt.write_mtx is tio.write_mtx
    assert gtt.read_binary is tio.read_binary
    assert gtt.write_binary is tio.write_binary
