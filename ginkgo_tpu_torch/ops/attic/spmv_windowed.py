"""Windowed-ELL SpMV (the attic generation): the counterpart of
``ginkgo_tpu/ops/attic/spmv_windowed.py``.

Layout (host planner, verbatim): rows in blocks of 128, 8 blocks to a
1024-row superblock; the j-th entry of each row in ELL slot j, slots in
groups of 8; per superblock an x window ``[xbase, xbase + XW)`` with
window-relative int16 columns ``c16``.  The entry's column is

    xbase_row[t] * 128 + c16[t, b*w8 + j, s, lane]

Entries that break the static bounds (slot >= w, window overflow, vreg
chunk spread > 8, slot spread > H) spill to a COO tail.  ``q0`` and ``H``
serve the TPU kernel's sublane select only; nothing here reads them.
``well_spmv_reference`` is the slab's plain version.  Kernel G, which
replaces ``ginkgo_tpu/ops/attic/spmv_windowed.py::_well_kernel``, is
``csrc/sell_spmv.cu`` (kernel B's source) over the slab's compact stream
(``ops/spmv_sell.py``: the slab's zero lanes dropped, each row in the
slab's (j, s) order), which ``upload`` builds; ``well_spmv`` in the
registry takes that stream.

Not imported by the package: ``from ginkgo_tpu_torch.ops.attic import
spmv_windowed`` registers ``well_spmv``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import spmv_sell
from ..registry import lookup, register
from ..spmv import coo_spmv
from ..spmv_sell import sell_from_windowed, sell_spmv_reference

LANES = 128
_ROWS_PER_BLOCK = 128
_BLOCKS_PER_SB = 8
_SB_ROWS = _ROWS_PER_BLOCK * _BLOCKS_PER_SB
_XW_CAP = 16384            # int16 window-relative columns need XW < 32768
_W_CAP = 64                # max ELL slots per row
ARRAYS = ("vals", "c16", "q0", "xbase_row")


def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def plan_windowed_layout(d, values_np, *, w_cap=_W_CAP, xw_cap=_XW_CAP,
                         h_quantile=0.995):
    """Build the windowed-ELL layout from canonical MatrixData.

    Returns (layout, tail, stats) or (None, None, stats) when the matrix
    has no rows.  ``layout`` holds numpy arrays: vals (Gs, w, 8, 128),
    c16 (Gs, w, 8, 128) int16, q0 (Gs, 8, w/8) int32, xbase_row (Gs,)
    int32, and ``meta`` (static ints).  ``tail`` is (rows, cols, vals)
    of spilled entries (possibly empty).
    """
    n, m = d.shape
    nnz = d.nnz
    if n == 0 or nnz == 0:
        return None, None, {"ell_nnz": 0, "tail_nnz": 0, "pad_ratio": np.inf}
    rows = d.row_idx.astype(np.int64)
    cols = d.col_idx.astype(np.int64)
    vals = values_np
    row_ptr = d.row_ptrs()
    degrees = row_ptr[1:] - row_ptr[:-1]

    # 1. slot assignment (j-th entry of each row); degree overflow -> tail
    slot = np.arange(nnz, dtype=np.int64) - row_ptr[rows]
    w = min(-(-int(degrees.max()) // 8) * 8, w_cap)
    spill = slot >= w

    n_pad = -(-n // _SB_ROWS) * _SB_ROWS
    Gs = n_pad // _SB_ROWS
    sb = rows // _SB_ROWS

    # 2. per-superblock x window base + width
    keep = ~spill
    mincol = np.full(Gs, np.int64(1) << 60)
    maxcol = np.full(Gs, -1, np.int64)
    np.minimum.at(mincol, sb[keep], cols[keep])
    np.maximum.at(maxcol, sb[keep], cols[keep])
    empty_sb = maxcol < 0
    mincol[empty_sb] = 0
    maxcol[empty_sb] = 0
    xbase = (mincol // LANES) * LANES
    span = maxcol - xbase + 1
    XW = min(_pow2ceil(int(span.max())), xw_cap)
    XW = max(XW, 1024)                      # >= 8 chunks for the q0 slice
    spill |= keep & (cols - xbase[sb] >= XW)
    keep = ~spill

    crel = np.where(keep, cols - xbase[sb], 0)
    sub = crel >> 7

    # 3. per-vreg-group chunk base q0 (vreg = block of 128 rows x 8 slots)
    w8 = w // 8
    blk = rows // _ROWS_PER_BLOCK          # global 128-row block id
    grp = slot // 8                        # slot group id
    n_blk = n_pad // _ROWS_PER_BLOCK
    vreg_id = blk * w8 + grp
    n_vreg = n_blk * w8
    vmin = np.full(n_vreg, np.int64(1) << 60)
    np.minimum.at(vmin, vreg_id[keep], sub[keep])
    vmin[vmin >= (np.int64(1) << 60)] = 0
    q0 = np.minimum(vmin, XW // LANES - 8)
    spill |= keep & (sub - q0[vreg_id] > 7)
    keep = ~spill

    # 4. per-slot (sublane) chunk spread -> static H
    slot_id = blk * w + slot               # global (block, slot) id
    n_slot = n_blk * w
    smin = np.full(n_slot, np.int64(1) << 60)
    np.minimum.at(smin, slot_id[keep], sub[keep])
    spread = np.where(keep, sub - smin[slot_id], 0)
    if keep.any():
        hq = int(np.quantile(spread[keep], h_quantile)) + 1
    else:
        hq = 1
    H = 2 if hq <= 2 else (4 if hq <= 4 else 8)
    spill |= keep & (spread >= H)
    keep = ~spill

    # recompute per-slot mins over survivors (pads use these); empty slots
    # pad at their vreg's q0 so the kernel's min-reduce stays in range
    smin = np.full(n_slot, np.int64(1) << 60)
    np.minimum.at(smin, slot_id[keep], sub[keep])
    sid = np.arange(n_slot, dtype=np.int64)
    svreg = (sid // w) * w8 + (sid % w) // 8
    empty_slot = smin >= (np.int64(1) << 60)
    smin[empty_slot] = q0[svreg[empty_slot]]

    # 5. final arrays
    ell_val = np.zeros((n_blk * _ROWS_PER_BLOCK, w), values_np.dtype)
    ell_c16 = np.broadcast_to((smin * LANES).astype(np.int64).reshape(
        n_blk, w)[:, None, :], (n_blk, _ROWS_PER_BLOCK, w)).reshape(
            n_blk * _ROWS_PER_BLOCK, w).copy()
    ell_val[rows[keep], slot[keep]] = vals[keep]
    ell_c16[rows[keep], slot[keep]] = crel[keep]

    # (n_pad, w) -> (Gs, 8 blocks, 128 rows, w slots) -> (Gs, w, 8*?, ...)
    # target [sb, b*w8 + j, s, l] = slot 8j+s of row 1024*sb + 128*b + l
    ev = ell_val.reshape(Gs, _BLOCKS_PER_SB, _ROWS_PER_BLOCK, w8, 8)
    ec = ell_c16.reshape(Gs, _BLOCKS_PER_SB, _ROWS_PER_BLOCK, w8, 8)
    vals_arr = np.ascontiguousarray(
        ev.transpose(0, 1, 3, 4, 2).reshape(Gs, w, 8, LANES))
    c16_arr = np.ascontiguousarray(
        ec.transpose(0, 1, 3, 4, 2).reshape(Gs, w, 8, LANES)
    ).astype(np.int16)
    # flat 1-D: SMEM pads the last dim of multi-D scalar operands to 128
    q0_arr = np.ascontiguousarray(q0.reshape(-1)).astype(np.int32)
    xbase_row = (xbase // LANES).astype(np.int32)
    xpad_rows = int(xbase_row.max()) + XW // LANES

    ell_nnz = int(keep.sum())
    tail = (rows[spill], cols[spill], vals[spill])
    stats = {"ell_nnz": ell_nnz, "tail_nnz": int(spill.sum()),
             "pad_ratio": Gs * w * _SB_ROWS / max(ell_nnz, 1),
             "H": H, "w": w, "XW": XW}
    meta = dict(n=n, m=m, Gs=Gs, w=w, w8=w8, XW=XW, H=H,
                xpad_rows=xpad_rows)
    layout = dict(vals=vals_arr, c16=c16_arr, q0=q0_arr,
                  xbase_row=xbase_row, meta=tuple(sorted(meta.items())))
    return layout, tail, stats


def _pad_x(b_col, meta):
    """(m,) vector -> (xpad_rows * 128,) zero-padded window source."""
    m, rows = meta["m"], meta["xpad_rows"]
    return F.pad(b_col, (0, rows * LANES - m))


def well_spmv_reference(vals, c16, q0, xbase_row, meta_items, b):
    """The function the windowed-ELL slab defines, by a plain gather from
    zero-padded x: the oracle that the compact stream is held against."""
    meta = dict(meta_items)
    Gs, n, w8 = meta["Gs"], meta["n"], meta["w8"]
    col_abs = (xbase_row[:, None, None, None].long() * LANES + c16.long())
    outs = []
    for kk in range(b.shape[1]):
        g = _pad_x(b[:, kk], meta)[col_abs]              # (Gs, w, 8, 128)
        prod = vals.to(b.dtype) * g
        # axis 1 enumerates (block b, slot group j) as b * w8 + j
        p = prod.reshape(Gs, _BLOCKS_PER_SB, w8, 8, LANES).sum(dim=(2, 3))
        outs.append(p.reshape(Gs * _SB_ROWS)[:n])
    return torch.stack(outs, dim=1)


register("well_spmv", "reference")(sell_spmv_reference)


@register("well_spmv", "cuda")
def well_spmv_cuda(sell, sell_meta, b):
    """Kernel G: the windowed-ELL SpMV/SpMM over the layout's compact
    stream (``spmv_sell.sell_from_windowed``) on ``csrc/sell_spmv.cu``, one
    launch per <= 8 columns.  f32 only, as the TPU kernel.

    A tensor on the CPU takes the plain version; on a CUDA device this
    launches the kernel or raises — it never falls back."""
    if b.device.type != "cuda":
        return sell_spmv_reference(sell, sell_meta, b)
    return spmv_sell.launch_f32(sell, sell_meta, b, "well_spmv",
                                well_spmv_cuda)


well_spmv_cuda.launches = 0    # kernel launches since the last reset


def upload_layout(layout, tail, device):
    """A planner's numpy ``layout`` arrays and COO ``tail`` as tensors on
    ``device``, in their planned dtypes; ``meta`` is carried over."""
    out = {key: torch.from_numpy(arr).to(device)
           for key, arr in layout.items() if key != "meta"}
    out["meta"] = layout["meta"]
    out["tail"] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in tail)
    return out


def upload(layout, tail, device):
    """The planned ``layout`` and COO ``tail`` as tensors on ``device``
    (``upload_layout``), plus the slab's compact stream ``sell`` and its
    ``sell_meta``, built there."""
    t = upload_layout(layout, tail, device)
    t["sell"], t["sell_meta"] = sell_from_windowed(
        t["vals"], t["c16"], t["xbase_row"], t["meta"])
    return t


def add_tail(y, tail, b):
    """y + (COO tail) @ b through the port's ``coo_spmv``."""
    rows, cols, vals = tail
    if rows.numel():
        y = y + coo_spmv(rows, cols, vals, b, y.shape[0])
    return y


def well_spmv_apply(t, b):
    """A @ b for an uploaded plan ``t``: the compact stream on the tier of
    b's device (kernel G on CUDA) plus the COO tail."""
    y = lookup("well_spmv", b.device)(t["sell"], t["sell_meta"], b)
    return add_tail(y, t["tail"], b)
