"""Matrix Market (+ Ginkgo's binary) I/O (``ginkgo_tpu/base/mtx_io.py``
for the port).

Analog of Ginkgo's ``include/ginkgo/core/base/mtx_io.hpp`` (``read_raw:33``,
``read_binary_raw:68``, ``write_raw:120``).  Parses on the host into
:class:`~ginkgo_tpu_torch.base.matrix_data.MatrixData`; the binary format IS
the reference's on-disk layout (``core/base/mtx_io.cpp:762-905``), so files
move between ``gko::read_binary_raw``/``write_binary_raw``, the JAX package
and the port unmodified (legacy npz files still read).

numpy has no bfloat16: a bf16 binary file is written from any real values
with ``value_dtype="bfloat16"`` (rounded to nearest even by
``torch.bfloat16``) and read back into float32 values, which hold every
bf16 value exactly.  The records move as their uint16 bit patterns.
"""

from __future__ import annotations

import io as _io
import os

import numpy as np
import torch

from .matrix_data import MatrixData

_MM_HEADER = "%%MatrixMarket"


def read_mtx(source) -> MatrixData:
    """Read a MatrixMarket file/stream/str into MatrixData.

    Supports coordinate + array formats; real/integer/complex/pattern fields;
    general/symmetric/skew-symmetric/hermitian symmetries.  A path takes the
    native C++ reader for the coordinate format.
    """
    if isinstance(source, (str, bytes)):
        try:
            is_path = isinstance(source, str) and os.path.exists(source)
        except (ValueError, OSError):  # very long strings
            is_path = False
        if is_path:
            from ..native import read_mtx_native
            native = read_mtx_native(source)
            if native is not None:
                shape, rows, cols, vals, symmetry = native
                return _assemble(shape, rows, cols, vals, symmetry)
            with open(source, "r") as f:
                return read_mtx(f)
        text = source.decode() if isinstance(source, bytes) else source
        return read_mtx(_io.StringIO(text))

    header = source.readline().split()
    if len(header) < 5 or header[0] != _MM_HEADER or header[1] != "matrix":
        raise ValueError(f"invalid MatrixMarket header: {header}")
    fmt, field, symmetry = header[2].lower(), header[3].lower(), header[4].lower()

    line = source.readline()
    while line.startswith("%"):
        line = source.readline()
    dims = line.split()

    is_complex = field == "complex"
    vdtype = np.complex128 if is_complex else np.float64

    if fmt == "coordinate":
        nrows, ncols, nnz = int(dims[0]), int(dims[1]), int(dims[2])
        rows = np.empty(nnz, np.int64)
        cols = np.empty(nnz, np.int64)
        vals = np.empty(nnz, vdtype)
        for k in range(nnz):
            parts = source.readline().split()
            rows[k] = int(parts[0]) - 1
            cols[k] = int(parts[1]) - 1
            if field == "pattern":
                vals[k] = 1.0
            elif is_complex:
                vals[k] = complex(float(parts[2]), float(parts[3]))
            else:
                vals[k] = float(parts[2])
    elif fmt == "array":
        if symmetry != "general":
            raise NotImplementedError("array format only supports 'general'")
        nrows, ncols = int(dims[0]), int(dims[1])
        dense = np.empty((nrows, ncols), vdtype)
        # column-major order per the MM spec
        for j in range(ncols):
            for i in range(nrows):
                parts = source.readline().split()
                dense[i, j] = (complex(float(parts[0]), float(parts[1]))
                               if is_complex else float(parts[0]))
        rows, cols = np.nonzero(np.ones_like(dense, dtype=bool))
        vals = dense[rows, cols]
    else:
        raise ValueError(f"unsupported MatrixMarket format {fmt!r}")

    return _assemble((nrows, ncols), rows, cols, vals, symmetry)


def _assemble(shape, rows, cols, vals, symmetry) -> MatrixData:
    if symmetry in ("symmetric", "hermitian", "skew-symmetric"):
        off = rows != cols
        orow, ocol, oval = cols[off], rows[off], vals[off]
        if symmetry == "hermitian":
            oval = np.conj(oval)
        elif symmetry == "skew-symmetric":
            oval = -oval
        rows = np.concatenate([rows, orow])
        cols = np.concatenate([cols, ocol])
        vals = np.concatenate([vals, oval])

    idt = np.int32 if max(shape) < 2**31 else np.int64
    return MatrixData(shape, rows.astype(idt), cols.astype(idt),
                      vals).sort_row_major()


def write_mtx(dest, data) -> None:
    """Write a matrix as a general coordinate MatrixMarket file.

    Accepts MatrixData, any operator with ``to_matrix_data`` (gko::write
    analog), or a dense array or tensor."""
    if not isinstance(data, MatrixData):
        if hasattr(data, "to_matrix_data"):
            data = data.to_matrix_data()
        else:
            if isinstance(data, torch.Tensor):
                data = data.cpu().numpy()
            data = MatrixData.from_dense(np.asarray(data))
    close = False
    if isinstance(dest, str):
        dest = open(dest, "w")
        close = True
    try:
        is_complex = np.iscomplexobj(data.values)
        field = "complex" if is_complex else "real"
        dest.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        dest.write(f"{data.shape[0]} {data.shape[1]} {data.nnz}\n")
        for r, c, v in zip(data.row_idx, data.col_idx, data.values):
            if is_complex:
                dest.write(f"{r + 1} {c + 1} {v.real:.17g} {v.imag:.17g}\n")
            else:
                dest.write(f"{r + 1} {c + 1} {v:.17g}\n")
    finally:
        if close:
            dest.close()


# Ginkgo's binary format (core/base/mtx_io.cpp:762-905): 32-byte header of
# four little-endian u64s — a magic whose bytes are b"GINKGO" + value-type
# char + index-type char, then num_rows, num_cols, num_entries — followed
# by num_entries packed (row, column, value) records.
_BIN_VALUE_CHARS = {"float64": b"D", "float32": b"S", "complex128": b"Z",
                    "complex64": b"C", "float16": b"H", "bfloat16": b"B"}
_BIN_VALUE_DTYPES = {v: k for k, v in _BIN_VALUE_CHARS.items()}
_BIN_INDEX_CHARS = {"int32": b"I", "int64": b"L"}
_BIN_INDEX_DTYPES = {v: k for k, v in _BIN_INDEX_CHARS.items()}


def _value_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _record_value_dtype(name) -> np.dtype:
    """The numpy type a record's value is stored as: bf16 as its uint16
    bit pattern."""
    return np.dtype(np.uint16 if name == "bfloat16" else name)


def _bf16_bits(values) -> np.ndarray:
    """Real values rounded to bf16 (nearest even), as uint16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(values, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16_values(bits) -> np.ndarray:
    """uint16 bf16 bit patterns -> float32 values (exact)."""
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16))
    return t.view(torch.bfloat16).float().numpy()


def write_binary(path: str, data: MatrixData, index_dtype="int64",
                 value_dtype=None) -> None:
    """Binary serialization in the reference's own format
    (``write_binary_raw``, ``core/base/mtx_io.cpp:762+``) — files round-trip
    with ``gko::read_binary_raw`` byte-for-byte.  ``value_dtype`` (default:
    the values' own) names the stored value type; ``"bfloat16"`` or
    ``torch.bfloat16`` rounds real values to bf16."""
    vname = _value_name(data.values.dtype if value_dtype is None
                        else value_dtype)
    if vname not in _BIN_VALUE_CHARS:
        raise ValueError(f"unsupported binary value type {vname}; one of "
                         f"{sorted(_BIN_VALUE_CHARS)}")
    iname = np.dtype(index_dtype).name
    if iname not in _BIN_INDEX_CHARS:
        raise ValueError(f"unsupported binary index type {iname}")
    imax = np.iinfo(iname).max
    if data.nnz and (int(np.max(data.row_idx)) > imax
                     or int(np.max(data.col_idx)) > imax):
        raise ValueError(
            f"indices exceed the {iname} range; use index_dtype='int64'")
    magic = (b"GINKGO" + _BIN_VALUE_CHARS[vname] + _BIN_INDEX_CHARS[iname])
    # '<'-prefixed: the format is unconditionally little-endian like the
    # header, regardless of host byte order
    rec = np.dtype([("r", np.dtype(iname).newbyteorder("<")),
                    ("c", np.dtype(iname).newbyteorder("<")),
                    ("v", _record_value_dtype(vname).newbyteorder("<"))])
    entries = np.empty(data.nnz, rec)
    entries["r"] = data.row_idx
    entries["c"] = data.col_idx
    if vname == "bfloat16":
        entries["v"] = _bf16_bits(data.values)
    else:
        entries["v"] = np.asarray(data.values).astype(vname, copy=False)
    with open(path, "wb") as f:
        f.write(magic)
        f.write(np.asarray([data.shape[0], data.shape[1], data.nnz],
                           "<u8").tobytes())
        f.write(entries.tobytes())


def read_binary(path: str) -> MatrixData:
    """Reads both the reference's binary format (``read_binary_raw``) and
    the legacy npz files; bf16 values come back as float32."""
    with open(path, "rb") as f:
        head = f.read(8)
        if head[:6] == b"GINKGO":
            vchar, ichar = head[6:7], head[7:8]
            if vchar not in _BIN_VALUE_DTYPES or \
                    ichar not in _BIN_INDEX_DTYPES:
                raise ValueError(
                    f"unknown binary type tag {head[6:8]!r}")
            dims = np.frombuffer(f.read(24), "<u8")
            n, m, nnz = (int(x) for x in dims)
            iname = _BIN_INDEX_DTYPES[ichar]
            vname = _BIN_VALUE_DTYPES[vchar]
            rec = np.dtype([
                ("r", np.dtype(iname).newbyteorder("<")),
                ("c", np.dtype(iname).newbyteorder("<")),
                ("v", _record_value_dtype(vname).newbyteorder("<"))])
            buf = f.read(nnz * rec.itemsize)
            if len(buf) != nnz * rec.itemsize:
                raise ValueError("truncated binary matrix file")
            entries = np.frombuffer(buf, rec)
            values = np.ascontiguousarray(entries["v"])
            if vname == "bfloat16":
                values = _bf16_values(values)
            return MatrixData(
                (n, m), entries["r"].astype(np.int64),
                entries["c"].astype(np.int64), values).sort_row_major()
    with np.load(path) as z:
        return MatrixData((int(z["shape"][0]), int(z["shape"][1])),
                          z["row_idx"], z["col_idx"], z["values"])
