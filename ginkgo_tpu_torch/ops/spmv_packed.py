"""Packed-slot windowed-ELL SpMV — the general-matrix fast path, the
counterpart of ``ginkgo_tpu/ops/spmv_packed.py``.

A *slot* is one 128-lane row holding the j-th entry in x-chunk ``c`` of
each of 128 matrix rows; slots are sorted by chunk and packed 8 per vreg
inside an aligned 8-chunk window of a per-superblock (1024-row) x window,
so an entry's column is

    (xbase_row[t] + 8 * qw[vreg] + (idx >> 7)) * 128 + (idx & 127)

with ``idx`` an int16.  This module holds the host layout planner
(verbatim), the slab's plain version ``pell_spmv_reference`` and kernel
B's wrapper ``pell_spmv_cuda``, which replaces the Pallas kernel
``ginkgo_tpu/ops/spmv_packed.py::_pell_kernel``.  The slab's shape serves
the TPU's gathers and pads the kept entries 3-4 times over, so the wrapper
runs ``csrc/sell_spmv.cu`` over the slab's compact stream
(``ops/spmv_sell.py``), built once at set-up; ``pell_spmv`` in the
registry takes that stream, and its plain version is
``spmv_sell.sell_spmv_reference``.

Complex values take the kernel's complex instantiation
(``pell_spmv_complex_cuda``, counted apart), in place of the TPU's re/im
plane split ``pell_spmv_complex``.

Entries that overflow the window or the slot budget spill to a COO tail
handled by ``coo_spmv``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import spmv_banded, spmv_sell
from .registry import register
from .spmv_sell import sell_spmv_reference

LANES = 128
_ROWS_PER_BLOCK = 128
_BLOCKS_PER_SB = 8
_SB_ROWS = _ROWS_PER_BLOCK * _BLOCKS_PER_SB
_XW_CAP = 16384
_WV_CAP = 192              # max vregs (of 8 slots) per 128-row block


def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def plan_packed_layout(d, values_np, *, wv_cap=_WV_CAP, xw_cap=_XW_CAP,
                       max_pad=None, max_tail=None):
    """Build the packed-slot layout from canonical MatrixData.

    Returns (layout, tail, stats); layout holds numpy arrays
    ``vals (Gs, 8*Wv, 8, 128)``, ``idx`` (same shape, int16, packed
    ``(chunk & 7) * 128 + lane``), ``qw (Gs*8*Wv,) int32`` (aligned
    window row-group per vreg, units of 8 rows), ``xbase_row (Gs,)``
    and static ``meta``.  ``tail`` is (rows, cols, vals) of spills.
    """
    n, m = d.shape
    nnz = d.nnz
    if n == 0 or nnz == 0:
        return None, None, {"ell_nnz": 0, "tail_nnz": 0,
                            "pad_ratio": np.inf}
    rows = d.row_idx.astype(np.int64)
    cols = d.col_idx.astype(np.int64)
    vals = values_np

    n_pad = -(-n // _SB_ROWS) * _SB_ROWS
    Gs = n_pad // _SB_ROWS
    n_blk = n_pad // _ROWS_PER_BLOCK
    sb = rows // _SB_ROWS
    blk = rows // _ROWS_PER_BLOCK

    # 1. per-superblock x window (>= 1024 so aligned 8-chunk groups fit)
    mincol = np.full(Gs, np.int64(1) << 60)
    maxcol = np.full(Gs, -1, np.int64)
    np.minimum.at(mincol, sb, cols)
    np.maximum.at(maxcol, sb, cols)
    empty_sb = maxcol < 0
    mincol[empty_sb] = 0
    maxcol[empty_sb] = 0
    xbase = (mincol // LANES) * LANES
    span = maxcol - xbase + 1
    XW = max(min(_pow2ceil(int(span.max())), xw_cap), 8 * LANES)
    spill = cols - xbase[sb] >= XW
    keep = ~spill

    crel = np.where(keep, cols - xbase[sb], 0)
    chunk = crel >> 7
    C = XW // LANES            # multiple of 8
    W8 = C // 8                # aligned 8-chunk window groups

    # 2. within-(row, chunk) position j (canonical order => contiguous
    #    runs; window spills are a per-row suffix, so j stays dense)
    key = np.where(keep, rows * C + chunk, -1)
    new_run = np.ones(nnz, bool)
    new_run[1:] = key[1:] != key[:-1]
    run_id = np.cumsum(new_run) - 1
    run_start = np.flatnonzero(new_run)
    j = np.arange(nnz) - run_start[run_id]

    # 3. per-(block, chunk) slot counts K; slots sorted by chunk pack
    #    into vregs within each aligned window group
    gid = blk * C + chunk
    K = np.zeros(n_blk * C, np.int64)
    np.maximum.at(K, gid[keep], j[keep] + 1)
    K2 = K.reshape(n_blk, W8, 8)
    S = K2.sum(axis=2)                       # slots per (block, wgroup)
    Vg = -(-S // 8)                          # vregs per (block, wgroup)
    V_b = Vg.sum(axis=1)
    Wv = int(min(max(int(V_b.max()), 1), wv_cap))

    # slot base of chunk (b, c): 8 * (vregs of earlier wgroups) +
    # slots of earlier chunks in the same wgroup
    vg_base = np.zeros_like(Vg)
    np.cumsum(Vg[:, :-1], axis=1, out=vg_base[:, 1:])
    in_grp = np.zeros_like(K2)
    np.cumsum(K2[:, :, :-1], axis=2, out=in_grp[:, :, 1:])
    chunk_base = (8 * vg_base)[:, :, None] + in_grp
    chunk_base = chunk_base.reshape(n_blk * C)

    s = chunk_base[gid] + j
    spill |= keep & (s >= Wv * 8)
    keep = ~spill

    # acceptance pre-check BEFORE materializing the padded arrays — the
    # dense vals/idx allocation below is hundreds of MB for matrices the
    # caller is about to reject anyway (measured 12 s per automatical
    # from_data on a 3.2M-nnz SpGEMM product)
    ell_pre = int(keep.sum())
    tail_pre = int(spill.sum())
    pad_pre = Gs * _BLOCKS_PER_SB * Wv * 8 * LANES / max(ell_pre, 1)
    if ((max_pad is not None and pad_pre > max_pad)
            or (max_tail is not None and tail_pre > max_tail * max(nnz, 1))):
        return None, None, {"ell_nnz": ell_pre, "tail_nnz": tail_pre,
                            "pad_ratio": pad_pre, "Wv": Wv, "XW": XW,
                            "rejected": True}

    # 4. per-vreg window group qw (vreg v of block b reads x rows
    #    [8*qw, 8*qw+8)); padding vregs use group 0
    qw = np.zeros((n_blk, Wv), np.int32)
    cnt = np.minimum(Vg, np.maximum(Wv - vg_base, 0)).reshape(-1)
    rep_b = np.repeat(np.repeat(np.arange(n_blk), W8), cnt)
    rep_w = np.repeat(np.tile(np.arange(W8), n_blk), cnt)
    starts = np.repeat(vg_base.reshape(-1), cnt)
    within = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    qw[rep_b, starts + within] = rep_w

    # 5. final dense arrays.  The kernel composes a sublane gather
    #    (idx >> 7) with a lane gather (idx & 127); that composition is
    #    only exact when the sublane index is CONSTANT within a slot —
    #    so padded lanes of a live slot must carry the slot's chunk in
    #    their index (their value is 0, so the gathered x is harmless).
    vals_arr = np.zeros((n_blk, Wv * 8, _ROWS_PER_BLOCK),
                        values_np.dtype)
    idx_arr = np.zeros((n_blk, Wv * 8, _ROWS_PER_BLOCK), np.int16)
    live = K > 0                                # (n_blk*C,) live chunks
    lg = np.flatnonzero(live)
    lcnt = K[lg]
    lbase = chunk_base[lg]
    lchunk = (lg % C) & 7
    pos = np.arange(lcnt.sum()) - np.repeat(np.cumsum(lcnt) - lcnt,
                                            lcnt)
    slot_ids = np.repeat(lbase, lcnt) + pos
    slot_blk = np.repeat(lg // C, lcnt)
    ok_slot = slot_ids < Wv * 8
    idx_arr[slot_blk[ok_slot], slot_ids[ok_slot], :] = (
        np.repeat(lchunk, lcnt)[ok_slot, None].astype(np.int16) * 128)
    lr = rows & 127
    vals_arr[blk[keep], s[keep], lr[keep]] = vals[keep]
    idx_arr[blk[keep], s[keep], lr[keep]] = (crel & 1023)[keep]
    vals_arr = np.ascontiguousarray(vals_arr.reshape(
        Gs, _BLOCKS_PER_SB * Wv, 8, LANES))
    idx_arr = np.ascontiguousarray(idx_arr.reshape(
        Gs, _BLOCKS_PER_SB * Wv, 8, LANES))
    qw_arr = np.ascontiguousarray(qw.reshape(-1))
    xbase_row = (xbase // LANES).astype(np.int32)
    xpad_rows = int(xbase_row.max()) + C

    ell_nnz = int(keep.sum())
    tail = (rows[spill], cols[spill], vals[spill])
    stats = {"ell_nnz": ell_nnz, "tail_nnz": int(spill.sum()),
             "pad_ratio": Gs * _BLOCKS_PER_SB * Wv * 8 * LANES
             / max(ell_nnz, 1), "Wv": Wv, "XW": XW}
    meta = dict(n=n, m=m, Gs=Gs, Wv=Wv, XW=XW, xpad_rows=xpad_rows)
    layout = dict(vals=vals_arr, idx=idx_arr, qw=qw_arr,
                  xbase_row=xbase_row, meta=tuple(sorted(meta.items())))
    return layout, tail, stats


def _pad_x(b_col, meta):
    m, rows = meta["m"], meta["xpad_rows"]
    return F.pad(b_col, (0, rows * LANES - m))


def pell_spmv_reference(vals, idx, qw, xbase_row, meta_items, b):
    """The function the packed slab defines, by a plain gather: the
    oracle that the compact stream is held against."""
    meta = dict(meta_items)
    Gs, Wv, n = meta["Gs"], meta["Wv"], meta["n"]
    qw2 = qw.reshape(Gs, _BLOCKS_PER_SB * Wv).long()
    i64 = idx.long()
    # absolute elem = (xbase + 8*qw + (idx>>7)) * 128 + (idx & 127)
    row_abs = (xbase_row[:, None].long() + 8 * qw2)[:, :, None, None] \
        + (i64 >> 7)
    flat = row_abs * LANES + (i64 & 127)
    outs = []
    for kk in range(b.shape[1]):
        g = _pad_x(b[:, kk], meta)[flat]
        prod = vals.to(b.dtype) * g
        p = prod.reshape(Gs, _BLOCKS_PER_SB, Wv, 8, LANES).sum(dim=(2, 3))
        outs.append(p.reshape(Gs * _SB_ROWS)[:n])
    return torch.stack(outs, dim=1)


# (value storage, vector) dtypes the kernel takes, and its complex
# instantiations (the same pairs as kernel A's)
KERNEL_DTYPES = spmv_banded.KERNEL_DTYPES
COMPLEX_KERNEL_DTYPES = spmv_banded.COMPLEX_KERNEL_DTYPES

register("pell_spmv", "reference")(sell_spmv_reference)


@register("pell_spmv", "cuda")
def pell_spmv_cuda(sell, sell_meta, b):
    """Kernel B: the packed SpMV/SpMM over the layout's compact stream
    (``spmv_sell.sell_from_packed``) on ``csrc/sell_spmv.cu``, one launch
    per <= 8 columns; complex operands go to its complex instantiation.

    A tensor on the CPU takes the plain version; on a CUDA device this
    launches the kernel or raises — it never falls back."""
    sv = sell["sv"]
    b = spmv_banded.kernel_vector(sv.dtype, b)
    if b.device.type != "cuda":
        return sell_spmv_reference(sell, sell_meta, b)
    if b.is_complex() or sv.is_complex():
        return pell_spmv_complex_cuda(sell, sell_meta, b)
    y = _output(sell, sell_meta, b, KERNEL_DTYPES)
    for c0 in range(0, b.shape[1], spmv_sell.MAX_RHS):
        spmv_sell.launch(sell, sell_meta, b, y, c0)
        pell_spmv_cuda.launches += 1
    return y


def pell_spmv_complex_cuda(sell, sell_meta, b):
    """Complex packed SpMV/SpMM on the complex instantiation of
    ``csrc/sell_spmv.cu`` (``COMPLEX_KERNEL_DTYPES``), one launch per <= 8
    columns: the counterpart of ``ginkgo_tpu/ops/spmv_packed.py::
    pell_spmv_complex``.

    A tensor on the CPU takes the plain version; on a CUDA device this
    launches the kernel or raises."""
    b = spmv_banded.kernel_vector(sell["sv"].dtype, b)
    if b.device.type != "cuda":
        return sell_spmv_reference(sell, sell_meta, b)
    y = _output(sell, sell_meta, b, COMPLEX_KERNEL_DTYPES)
    for c0 in range(0, b.shape[1], spmv_sell.MAX_RHS):
        spmv_sell.launch(sell, sell_meta, b, y, c0)
        pell_spmv_complex_cuda.launches += 1
    return y


def _output(sell, sell_meta, b, dtypes):
    sv = sell["sv"]
    if (sv.dtype, b.dtype) not in dtypes:
        raise TypeError(f"pell_spmv kernel takes (values, vector) dtypes "
                        f"{sorted(map(str, dtypes))}, got "
                        f"({sv.dtype}, {b.dtype})")
    return spmv_sell.prepare(sell, sell_meta, b, "pell_spmv")


pell_spmv_cuda.launches = 0           # kernel launches since the last reset
pell_spmv_complex_cuda.launches = 0   # complex launches since the last reset
