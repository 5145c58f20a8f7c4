"""Chunk-ELL SpMV (the attic generation): the counterpart of
``ginkgo_tpu/ops/attic/spmv_chunked.py``.

Layout (host planner, verbatim): rows in blocks of 128, 8 blocks to a
1024-row superblock sharing one x window; within a block each row's
entries are grouped by x chunk (``(col - window_base) // 128``) and the
j-th entry of a (row, chunk) lands in slot ``slot_base[block, chunk] + j``;
8 slots form a vreg whose chunk ``qid`` is fixed.  The entry's column is

    (xbase_row[t] + qid[(t*8 + b)*Wv + v]) * 128 + lanes[t, b*Wv + v, s, lane]

Per-block vreg counts are padded to ``Wv``; overflow entries spill to a COO
tail.  ``cell_spmv_reference`` is the slab's plain version.  Kernel H,
which replaces ``ginkgo_tpu/ops/attic/spmv_chunked.py::_cell_kernel``, is
``csrc/sell_spmv.cu`` (kernel B's source) over the slab's compact stream
(``ops/spmv_sell.py``, 5.5 times smaller on the FEM matrix), which
``upload`` builds; ``cell_spmv`` in the registry takes that stream.

Not imported by the package: ``from ginkgo_tpu_torch.ops.attic import
spmv_chunked`` registers ``cell_spmv``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import spmv_sell
from ..registry import lookup, register
from ..spmv_sell import sell_from_chunked, sell_spmv_reference
from . import spmv_windowed
from .spmv_windowed import add_tail

LANES = 128
_ROWS_PER_BLOCK = 128
_BLOCKS_PER_SB = 8
_SB_ROWS = _ROWS_PER_BLOCK * _BLOCKS_PER_SB
_XW_CAP = 16384
_WV_CAP = 128              # max vregs (of 8 slots) per 128-row block
ARRAYS = ("vals", "lanes", "qid", "xbase_row")


def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def plan_chunked_layout(d, values_np, *, wv_cap=_WV_CAP, xw_cap=_XW_CAP):
    """Build the chunk-ELL layout from canonical MatrixData.

    Returns (layout, tail, stats); layout holds numpy arrays
    ``vals (Gs, 8*Wv, 8, 128)``, ``lanes`` (same shape, int16), ``qid
    (Gs*8*Wv,) int32`` (window-relative chunk row per vreg),
    ``xbase_row (Gs,) int32`` and static ``meta``.  ``tail`` is
    (rows, cols, vals) of spilled entries.
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

    # 1. per-superblock x window
    mincol = np.full(Gs, np.int64(1) << 60)
    maxcol = np.full(Gs, -1, np.int64)
    np.minimum.at(mincol, sb, cols)
    np.maximum.at(maxcol, sb, cols)
    empty_sb = maxcol < 0
    mincol[empty_sb] = 0
    maxcol[empty_sb] = 0
    xbase = (mincol // LANES) * LANES
    span = maxcol - xbase + 1
    XW = max(min(_pow2ceil(int(span.max())), xw_cap), LANES)
    spill = cols - xbase[sb] >= XW
    keep = ~spill

    crel = np.where(keep, cols - xbase[sb], 0)
    chunk = crel >> 7
    lane = crel & 127
    C = XW // LANES

    # 2. within-(row, chunk) position j (entries are in canonical
    #    row-major, column-sorted order, so (row, chunk) runs are
    #    contiguous; spilled entries must not advance j)
    key = np.where(keep, rows * C + chunk, -1)
    new_run = np.ones(nnz, bool)
    new_run[1:] = key[1:] != key[:-1]
    run_id = np.cumsum(new_run) - 1
    run_start = np.flatnonzero(new_run)
    j = np.arange(nnz) - run_start[run_id]
    # spilled entries inside a run create gaps; renumber survivors only
    j = j - np.where(keep, 0, 0)  # runs with key=-1 are isolated; keep j
    # (a spilled entry splits its own run because its key is -1, so
    #  surviving runs are contiguous and j is correct for them)

    # 3. per-(block, chunk) slot counts, rounded to vregs of 8
    gid = blk * C + chunk
    K = np.zeros(n_blk * C, np.int64)
    np.maximum.at(K, gid[keep], j[keep] + 1)
    Kr = -(-K // 8) * 8
    # slot bases: per block, exclusive cumsum over its C chunks
    Kr2 = Kr.reshape(n_blk, C)
    base2 = np.zeros_like(Kr2)
    np.cumsum(Kr2[:, :-1], axis=1, out=base2[:, 1:])
    slot_base = base2.reshape(-1)
    V_b = Kr2.sum(axis=1) // 8
    Wv = int(min(max(int(V_b.max()), 1), wv_cap))

    s = slot_base[gid] + j
    spill |= keep & (s >= Wv * 8)
    keep = ~spill

    # 4. per-vreg chunk ids (vreg v of block b covers slots 8v..8v+7)
    qid = np.zeros((n_blk, Wv), np.int32)
    nv = np.minimum(Kr2 // 8, Wv)                     # vregs per group
    first_v = np.minimum(base2 // 8, Wv)
    bidx = np.repeat(np.arange(n_blk), C)
    cidx = np.tile(np.arange(C), n_blk)
    cnt = np.minimum(nv.reshape(-1),
                     np.maximum(Wv - first_v.reshape(-1), 0))
    rep_b = np.repeat(bidx, cnt)
    rep_c = np.repeat(cidx, cnt)
    starts = np.repeat(first_v.reshape(-1), cnt)
    within = np.arange(cnt.sum()) - np.repeat(
        np.cumsum(cnt) - cnt, cnt)
    qid[rep_b, starts + within] = rep_c

    # 5. final dense arrays
    vals_arr = np.zeros((n_blk, Wv * 8, _ROWS_PER_BLOCK),
                        values_np.dtype)
    lane_arr = np.zeros((n_blk, Wv * 8, _ROWS_PER_BLOCK), np.int16)
    lr = rows & 127
    vals_arr[blk[keep], s[keep], lr[keep]] = vals[keep]
    lane_arr[blk[keep], s[keep], lr[keep]] = lane[keep]
    # (n_blk, Wv*8, 128) -> (Gs, 8 blocks, Wv, 8 sub, 128) ->
    # axis-1 enumerates (b, v): [sb, b*Wv + v, sub, lane]
    vals_arr = vals_arr.reshape(Gs, _BLOCKS_PER_SB, Wv, 8, LANES)
    lane_arr = lane_arr.reshape(Gs, _BLOCKS_PER_SB, Wv, 8, LANES)
    vals_arr = np.ascontiguousarray(
        vals_arr.reshape(Gs, _BLOCKS_PER_SB * Wv, 8, LANES))
    lane_arr = np.ascontiguousarray(
        lane_arr.reshape(Gs, _BLOCKS_PER_SB * Wv, 8, LANES))
    qid_arr = np.ascontiguousarray(qid.reshape(-1))
    xbase_row = (xbase // LANES).astype(np.int32)
    xpad_rows = int(xbase_row.max()) + XW // LANES

    ell_nnz = int(keep.sum())
    tail = (rows[spill], cols[spill], vals[spill])
    stats = {"ell_nnz": ell_nnz, "tail_nnz": int(spill.sum()),
             "pad_ratio": Gs * _BLOCKS_PER_SB * Wv * 8 * LANES
             / max(ell_nnz, 1), "Wv": Wv, "XW": XW}
    meta = dict(n=n, m=m, Gs=Gs, Wv=Wv, XW=XW, xpad_rows=xpad_rows)
    layout = dict(vals=vals_arr, lanes=lane_arr, qid=qid_arr,
                  xbase_row=xbase_row, meta=tuple(sorted(meta.items())))
    return layout, tail, stats


def _pad_x(b_col, meta):
    m, rows = meta["m"], meta["xpad_rows"]
    return F.pad(b_col, (0, rows * LANES - m))


def cell_spmv_reference(vals, lanes, qid, xbase_row, meta_items, b):
    """The function the chunk-ELL slab defines, by a plain gather from
    zero-padded x: the oracle that the compact stream is held against."""
    meta = dict(meta_items)
    Gs, Wv, n = meta["Gs"], meta["Wv"], meta["n"]
    qid2 = qid.reshape(Gs, _BLOCKS_PER_SB * Wv).long()
    col_abs = ((xbase_row[:, None].long() + qid2) * LANES)[:, :, None, None] \
        + lanes.long()
    outs = []
    for kk in range(b.shape[1]):
        g = _pad_x(b[:, kk], meta)[col_abs]            # (Gs, 8*Wv, 8, 128)
        prod = vals.to(b.dtype) * g
        p = prod.reshape(Gs, _BLOCKS_PER_SB, Wv, 8, LANES).sum(dim=(2, 3))
        outs.append(p.reshape(Gs * _SB_ROWS)[:n])
    return torch.stack(outs, dim=1)


register("cell_spmv", "reference")(sell_spmv_reference)


@register("cell_spmv", "cuda")
def cell_spmv_cuda(sell, sell_meta, b):
    """Kernel H: the chunk-ELL SpMV/SpMM over the layout's compact stream
    (``spmv_sell.sell_from_chunked``) on ``csrc/sell_spmv.cu``, one launch
    per <= 8 columns.  f32 only, as the TPU kernel.

    A tensor on the CPU takes the plain version; on a CUDA device this
    launches the kernel or raises — it never falls back."""
    if b.device.type != "cuda":
        return sell_spmv_reference(sell, sell_meta, b)
    return spmv_sell.launch_f32(sell, sell_meta, b, "cell_spmv",
                                cell_spmv_cuda)


cell_spmv_cuda.launches = 0    # kernel launches since the last reset


def upload(layout, tail, device):
    """The planned ``layout`` and COO ``tail`` as tensors on ``device``
    (``spmv_windowed.upload_layout``), plus the slab's compact stream
    ``sell`` and its ``sell_meta``, built there."""
    t = spmv_windowed.upload_layout(layout, tail, device)
    t["sell"], t["sell_meta"] = sell_from_chunked(
        *(t[key] for key in ARRAYS), t["meta"])
    return t


def cell_spmv_apply(t, b):
    """A @ b for an uploaded plan ``t``: the compact stream on the tier of
    b's device (kernel H on CUDA) plus the COO tail."""
    y = lookup("cell_spmv", b.device)(t["sell"], t["sell_meta"], b)
    return add_tail(y, t["tail"], b)
