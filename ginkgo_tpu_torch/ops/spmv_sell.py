"""The compact sliced stream behind kernels B, G and H.

The TPU's packed-slot slab (``ops/spmv_packed.py``), windowed-ELL slab
(``ops/attic/spmv_windowed.py``) and chunk-ELL slab
(``ops/attic/spmv_chunked.py``) give each 128-row block as many slots as
its densest row (for the chunk-ELL slab, a block and x chunk), rounded up
to vregs of 8: a sublane/lane shape for the TPU's gathers.  On the
permuted main-path stencil the packed slab holds 3.6 times the kept
entries, on the FEM matrix 3.4 (packed) and 5.5 (chunked) times.  Hopper
needs none of it, so each slab is repacked once, at set-up and on the
slab's own device, into one stream that the three kernels' wrappers hand
to ``csrc/sell_spmv.cu``:

- slices of 32 consecutive rows (a warp); 32 slices to a 1024-row
  superblock, so a slice never crosses one;
- ``sp`` ``(n_slices + 1,)`` int64: slice offsets, ``32 * width`` entries a
  slice, ``width`` the longest row of the slice;
- entry j of the slice's lane l at ``sp[s] + 32 j + l``;
- ``sv``: values in the slab's value dtype (complex ones interleaved, as
  torch stores them);
- ``sc``: int16 column relative to the superblock's x window,
  ``col - 128 * xbase[s // 32]``, in ``[0, XW)`` with ``XW <= 16384``;
- ``xbase``: the slab's ``xbase_row`` (int32, one a superblock).

Each row keeps its entries in the slab's order (vreg v, then sublane s),
which is the order the slab kernels summed in.  The slab's padding lanes
(value exactly 0) are dropped: they add ``0 * x = ±0``, which leaves every
sum unchanged for finite x (an explicitly stored zero goes with them).
Rows shorter than their slice's longest are padded with value 0 and
column 0.
"""

from __future__ import annotations

import torch

from . import _cuda

SLICE = 32                 # rows a slice: one warp, a thread a row
_SB_ROWS = 1024            # rows a superblock: one x window
_SLOTS_PER_VREG = 8 * 128
STREAM = ("sv", "sc", "sp", "xbase")
MAX_RHS = 8                # columns a launch; the stream is read once a launch


def _compact(vals, rel_col, xbase_row, meta_items):
    """The stream of a (Gs, 8*Wv, 8, 128) slab whose entry at flat slab
    index e lies in window-relative column ``rel_col(e)``."""
    meta = dict(meta_items)
    n, m, Gs, Wv, XW = (meta[key] for key in ("n", "m", "Gs", "Wv", "XW"))
    n_slices = -(-n // SLICE)
    # the kept lanes, row by row: row r = 1024 t + 128 b + lane reads
    # vreg (t*8 + b)*Wv + v, sublane s, in the order (v, s); one mask over
    # both parts of a complex value, so an entry with a zero real part
    # keeps its imaginary part
    keep = (vals != 0).reshape(Gs, 8, Wv, 8, 128).permute(0, 1, 4, 2, 3)
    keep = keep.reshape(Gs * _SB_ROWS, Wv * 8)[:n_slices * SLICE]
    row, pos = keep.nonzero(as_tuple=True)       # row-major: slab order
    count = keep.sum(dim=1)
    width = count.reshape(n_slices, SLICE).amax(dim=1)
    sp = torch.zeros(n_slices + 1, dtype=torch.int64, device=vals.device)
    sp[1:] = torch.cumsum(SLICE * width, dim=0)
    rank = (torch.arange(row.numel(), device=vals.device)
            - (torch.cumsum(count, dim=0) - count)[row])
    in_sb = row % _SB_ROWS
    e = ((((row // _SB_ROWS) * 8 + in_sb // 128) * Wv + pos // 8)
         * _SLOTS_PER_VREG + (pos % 8) * 128 + in_sb % 128)
    dest = sp[row // SLICE] + SLICE * rank + row % SLICE
    total = int(sp[-1])
    sv = torch.zeros(total, dtype=vals.dtype, device=vals.device)
    sc = torch.zeros(total, dtype=torch.int16, device=vals.device)
    sv[dest] = vals.reshape(-1)[e]
    sc[dest] = rel_col(e).to(torch.int16)
    sell = dict(sv=sv, sc=sc, sp=sp, xbase=xbase_row.contiguous())
    smeta = dict(n=n, m=m, n_slices=n_slices, XW=XW, entries=int(row.numel()))
    return sell, tuple(sorted(smeta.items()))


def sell_from_packed(vals, idx, qw, xbase_row, meta):
    """The stream of kernel B's packed-slot slab: the column of slab entry
    e is ``(xbase_row[t] + 8 qw[v] + (idx >> 7)) * 128 + (idx & 127)``
    (``spmv_packed.pell_spmv_reference``).  Returns (sell, meta items)."""
    idx_flat, qw = idx.reshape(-1), qw.long()

    def rel_col(e):
        i = idx_flat[e].long()
        return (8 * qw[e // _SLOTS_PER_VREG] + (i >> 7)) * 128 + (i & 127)

    return _compact(vals, rel_col, xbase_row, meta)


def sell_from_chunked(vals, lanes, qid, xbase_row, meta):
    """The stream of kernel H's chunk-ELL slab: the column of slab entry e
    is ``(xbase_row[t] + qid[v]) * 128 + lanes`` (``attic.spmv_chunked.
    cell_spmv_reference``).  Returns (sell, meta items)."""
    lanes_flat, qid = lanes.reshape(-1), qid.long()

    def rel_col(e):
        return qid[e // _SLOTS_PER_VREG] * 128 + lanes_flat[e].long()

    return _compact(vals, rel_col, xbase_row, meta)


def sell_from_windowed(vals, c16, xbase_row, meta):
    """The stream of kernel G's windowed-ELL slab: axis 1 is ``b*w8 + j``
    with sublane ``s`` (slot 8j+s of row 128 b + lane), so the slab walks
    as a packed one with ``Wv = w8``, and the column of slab entry e is
    ``xbase_row[t] * 128 + c16[e]`` (``attic.spmv_windowed.
    well_spmv_reference``).  Returns (sell, meta items)."""
    c16_flat = c16.reshape(-1)
    meta = dict(meta, Wv=dict(meta)["w8"])

    def rel_col(e):
        return c16_flat[e].long()

    return _compact(vals, rel_col, xbase_row, tuple(sorted(meta.items())))


def sell_spmv_reference(sell, meta_items, b):
    """Plain version of ``csrc/sell_spmv.cu``: every stream entry's
    product added to its row, in stream order (so each row in slab
    order)."""
    meta = dict(meta_items)
    sv, sc, sp, xbase = (sell[key] for key in STREAM)
    n_slices = meta["n_slices"]
    width = (sp[1:] - sp[:-1]) // SLICE
    sl = torch.repeat_interleave(torch.arange(n_slices, device=sp.device),
                                 SLICE * width, output_size=sv.numel())
    e = torch.arange(sv.numel(), device=sp.device)
    row = SLICE * sl + (e - sp[sl]) % SLICE
    col = 128 * xbase.long()[sl // SLICE] + sc.long()
    y = torch.zeros((n_slices * SLICE, b.shape[1]), dtype=b.dtype,
                    device=b.device)
    y.index_add_(0, row, sv.to(b.dtype)[:, None] * b[col])
    return y[:meta["n"]]


def prepare(sell, meta_items, b, name):
    """Check that ``sell`` and ``b`` fit the kernel and return the (n, k)
    output; raises ``ValueError`` on what the kernel does not take."""
    meta = dict(meta_items)
    n, m, n_slices = meta["n"], meta["m"], meta["n_slices"]
    sv, sc, sp, xbase = (sell[key] for key in STREAM)
    if (sv.ndim != 1 or tuple(sc.shape) != tuple(sv.shape)
            or sc.dtype != torch.int16 or tuple(sp.shape) != (n_slices + 1,)
            or sp.dtype != torch.int64 or xbase.dtype != torch.int32
            or xbase.numel() * (_SB_ROWS // SLICE) < n_slices
            or b.ndim != 2 or b.shape[0] != m
            or not 0 < n <= n_slices * SLICE):
        raise ValueError(
            f"{name}: stream sv {tuple(sv.shape)} sc {tuple(sc.shape)}/"
            f"{sc.dtype} sp {tuple(sp.shape)}/{sp.dtype} xbase "
            f"{tuple(xbase.shape)}/{xbase.dtype} and b {tuple(b.shape)} do "
            f"not fit meta {meta}")
    if any(t.device != b.device for t in (sv, sc, sp, xbase)):
        raise ValueError(f"{name}: stream and b must share one device")
    if not all(t.is_contiguous() for t in (sv, sc, sp, xbase, b)):
        raise ValueError(f"{name}: stream and b must be contiguous")
    return torch.empty((n, b.shape[1]), dtype=b.dtype, device=b.device)


def launch(sell, meta_items, b, y, c0):
    """One launch of ``csrc/sell_spmv.cu`` for columns ``[c0, c0 + 8)`` of
    ``b`` into the same columns of ``y`` (both from ``prepare``)."""
    meta = dict(meta_items)
    sv, sc, sp, xbase = (sell[key] for key in STREAM)
    k = b.shape[1]
    esize = b.element_size()
    lib = _cuda.library("sell_spmv")
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        code = lib.sell_spmv_launch(
            _cuda.type_code(sv.dtype), _cuda.type_code(b.dtype),
            sv.data_ptr(), sc.data_ptr(), sp.data_ptr(), xbase.data_ptr(),
            meta["n_slices"], meta["n"], meta["m"],
            b.data_ptr() + c0 * esize, k, y.data_ptr() + c0 * esize, k,
            min(MAX_RHS, k - c0), stream)
    _cuda.check("sell_spmv", code)


def launch_f32(sell, meta_items, b, name, wrapper):
    """The attic kernels' CUDA path (G, H: f32 only, as their TPU kernels):
    one launch of ``csrc/sell_spmv.cu`` per <= 8 columns of ``b``, each
    counted on ``wrapper.launches``; raises on other types."""
    if sell["sv"].dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes f32 values and vectors, "
                        f"got ({sell['sv'].dtype}, {b.dtype})")
    y = prepare(sell, meta_items, b, name)
    for c0 in range(0, b.shape[1], MAX_RHS):
        launch(sell, meta_items, b, y, c0)
        wrapper.launches += 1
    return y
