"""Pair contraction ``y[po] += a[pl] * b[pu]`` over a static, presorted
contribution-pair list (``ginkgo_tpu/ops/pair_contract.py`` in torch).

This is the irregular-contraction primitive behind device-resident
incomplete factorization on unstructured patterns (the device ParILUT and
ParICT loops of ``factorization/par_ilut_packed.py``): with the slot
universe fixed, one Chow-Patel sweep or candidate product IS this
contraction.  The host planner (verbatim from the JAX package, same
constants, so planned arrays are bit-identical) tiles the output slots
1024 per tile and packs each tile's pairs into "vregs" of 1024 slots,
each reading ``a`` and ``b`` through a small window (``lq``/``uq`` row
starts inside the tile window ``lbase``/``ubase``) with int16 offsets
``pls``/``pus``.  Pairs stay po-ascending within a vreg, so two more int16
streams ``pes``/``pesp`` (cumulative pair counts at/before each output
slot) turn the vreg's scatter into ``cs[pes-1] - cs[pesp-1]`` over the
inclusive prefix ``cs`` of its 1024 products; ``pos`` (the output slot of
each pair, 1024 on padding) is the stream of the one-hot formulation.
Pairs that escape a window or the per-tile vreg budget go to a COO tail.

Tiers:

* ``pair_contract`` ``reference``: raw-triple gather x gather + ``index_add_``.
* ``pair_contract_planned`` ``reference``: the raw triple when the plan
  carries one, else the plain torch version of the kernels' arithmetic on
  the planned streams for the active ``_DOT_MODE`` (the counterpart of the
  JAX package's ``pair_contract_pallas(..., interpret=True)``).
* ``pair_contract_planned`` ``cuda``: kernel D (``"cumsum_batched"``, the
  default; replaces ``_pair_kernel_batched``) or kernel E (``"onehot"``;
  replaces ``_pair_kernel``), both in ``csrc/pair_contract.cu``, then the
  COO tail in the same launch (the JAX package leaves the tail to XLA).
  The kernels read the plan's pad-free pair stream (``pair_stream``,
  repacked once on the card: each live vreg's real pairs, 6 B of int16
  indices a pair), not the padded slabs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .registry import register

LANES = 128
_OW = 1024                  # output slots per grid tile
_NV_CAP = 96                # max pair vregs per tile
_WIN_ROWS_CAP = 2048        # max (rows, 128) window per operand
_DOT_MODE = "cumsum_batched"   # scatter strategy: "cumsum_batched"
# (default: sorted-po cumsum-difference, kernel D) or "onehot" (the
# direct slot scatter, kernel E; kept as the independent formulation)


def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


_MAX_SHIFT = 5              # per-vreg window <= 8<<5 = 256 rows (int16)


def _select_shifts(pl_, pu_, po_, n_out, nv_cap):
    """Pick the per-vreg gather-window shifts (sl, su): coarse group
    keys ``block >> s`` trade gather reach (the select-loop cost grows
    linearly with 8<<s window rows) for vreg fill — wide-spread
    patterns fragment (tile, ublock, lblock) groups into ~100-pair
    shards that pad to 6% fill at s=0 (the +-600-col FEM class).
    Estimates per-tile vreg counts and fill for each (sl, su) on a sample
    of output tiles (tiles are contiguous in the po-sorted list) and
    minimizes a padded-pairs x gather-cost model, requiring the per-tile
    vreg budget to hold."""
    T = -(-int(n_out) // _OW)
    tiles = np.unique(np.linspace(0, T - 1, 48, dtype=np.int64))
    bounds = np.searchsorted(po_, np.stack([tiles * _OW,
                                            (tiles + 1) * _OW]).ravel())
    starts, ends = bounds[:len(tiles)], bounds[len(tiles):]
    shifts = range(_MAX_SHIFT + 1)
    stats = {(sl, su): [0, 0, 0] for sl in shifts for su in shifts}
    npairs_s = 0
    for s, e in zip(starts, ends):
        if e <= s:
            continue
        # clipped-boundary tiles can hold millions of pairs; the stats
        # only need the group-size distribution, so bound per-tile work
        # (a truncated prefix under-counts that tile's vregs — fine,
        # such tiles overflow any budget and spill regardless)
        e = min(e, s + (1 << 21))
        npairs_s += e - s
        fine = ((np.asarray(pu_[s:e], np.int64) >> 10) << 21) \
            | (np.asarray(pl_[s:e], np.int64) >> 10)
        fkey, fcnt = np.unique(fine, return_counts=True)
        for sl in shifts:
            for su in shifts:
                ck = (((fkey >> 21) >> su) << 21) | ((fkey &
                                                      0x1FFFFF) >> sl)
                order = np.argsort(ck, kind="stable")
                cks = ck[order]
                seg = np.ones(len(cks), bool)
                seg[1:] = cks[1:] != cks[:-1]
                sizes = np.add.reduceat(fcnt[order], np.flatnonzero(seg))
                # greedy packing splits a group every _OW pairs; coarse
                # groups merge fine ones so boundaries never split a
                # fine group mid-stream
                v = int(np.sum(-(-sizes // _OW)))
                st = stats[(sl, su)]
                st[0] += v
                st[1] = max(st[1], v)
                st[2] += 1
    if npairs_s == 0:
        return 0, 0
    cost = {}
    for (sl, su), (vtot, vmax, _) in stats.items():
        feasible = vmax <= nv_cap
        # calibrated on the TPU kernel (scatter/DMA-bound, padded
        # throughput flat up to ~64-row windows): ns/padded-pair fits
        # 0.28 + 0.0013*(GWL+GWU) => cost constant 224 rows.  Kept
        # verbatim so the port plans the same streams
        cost[(sl, su)] = (not feasible,
                          vtot * _OW * (224 + (8 << sl) + (8 << su)))
    best = min(cost, key=lambda k: cost[k])
    # hysteresis: keep the historical (0, 0) plan shape unless the
    # coarse grouping is a clear (>=1.3x) win
    if cost[(0, 0)][0] == cost[best][0] and \
            cost[(0, 0)][1] <= 1.3 * cost[best][1]:
        return 0, 0
    return best


def plan_pair_contract(pl_, pu_, po_, n_out, n_a, n_b, *,
                       max_tail=0.05, nv_cap=_NV_CAP, shifts=None):
    """Static plan for the kernel tier.  ``po_`` must be sorted
    ascending.  Returns a dict of numpy arrays + static meta, or None
    when windows/budgets reject (callers fall back to the reference
    tier or reject the whole device path).

    ``shifts=(sl, su)`` sets the per-vreg gather-window coarsening
    (window = 8<<s rows per operand); None auto-selects on large pair
    lists via `_select_shifts` (wide-spread patterns need coarse
    windows to reach usable vreg fill).

    Planning runs in the native tier when available (one per-tile sort
    + two linear walks, ~10x the numpy planner below on 1e8-pair
    lists); the numpy body is the oracle and the fallback."""
    npairs = len(po_)
    if npairs == 0 or n_out == 0:
        return None
    if max(n_out, n_a, n_b) >= (1 << 31):
        return None
    # The sorted-po precondition is load-bearing: pes/pesp are cumulative
    # pair counts, valid only when pairs are po-ascending within each
    # vreg, which the planners' STABLE group sorts preserve only from a
    # po-ascending input.  The summation itself is order-free, so an
    # unsorted list is fixed here with one stable po-sort (preserving
    # emitter pu order within equal po) rather than planned as-is.
    po_ = np.asarray(po_)
    if npairs > 1 and not bool(np.all(po_[1:] >= po_[:-1])):
        order = np.argsort(po_, kind="stable")
        pl_ = np.asarray(pl_)[order]
        pu_ = np.asarray(pu_)[order]
        po_ = po_[order]
        del order
    if shifts is None:
        # auto-coarsening only where fragmentation can hurt: small
        # lists always fit at (0, 0) and keep their historical plans
        shifts = (_select_shifts(pl_, pu_, po_, n_out, nv_cap)
                  if npairs >= (1 << 22) else (0, 0))
    sl, su = int(shifts[0]), int(shifts[1])
    if not (0 <= sl <= _MAX_SHIFT and 0 <= su <= _MAX_SHIFT):
        raise ValueError(f"shifts out of range [0, {_MAX_SHIFT}]: "
                         f"{(sl, su)} (int16 window indices)")
    from ..native import pair_plan_native
    nat = pair_plan_native(pl_, pu_, po_, n_out, nv_cap,
                           _WIN_ROWS_CAP, max_tail, sl, su)
    if nat == "reject":
        return None
    if nat is not None:
        T, NV = nat["T"], nat["NV"]
        WLr, WUr = nat["WLr"], nat["WUr"]
        lbase, ubase = nat["lbase"], nat["ubase"]
        pad_rows_a = int(lbase.max()) + WLr
        pad_rows_b = int(ubase.max()) + WUr
        meta = dict(T=T, NV=NV, WLr=WLr, WUr=WUr, n_out=int(n_out),
                    n_a=int(n_a), n_b=int(n_b),
                    GWL=8 << sl, GWU=8 << su,
                    pad_rows_a=max(pad_rows_a, -(-int(n_a) // LANES)),
                    pad_rows_b=max(pad_rows_b, -(-int(n_b) // LANES)))
        fill = float(npairs - len(nat["tail"][0])) / (T * NV * _OW)
        return dict(pls=nat["pls"].reshape(T, NV, 8, LANES),
                    pus=nat["pus"].reshape(T, NV, 8, LANES),
                    pos=nat["pos"].reshape(T, NV, 8, LANES),
                    pes=nat["pes"].reshape(T, NV, 8, LANES),
                    pesp=nat["pesp"].reshape(T, NV, 8, LANES),
                    lq=nat["lq"], uq=nat["uq"], nv=nat["nv"],
                    lbase=lbase.astype(np.int32),
                    ubase=ubase.astype(np.int32),
                    tail=nat["tail"],
                    meta=tuple(sorted(meta.items())), fill=fill)
    return _plan_pair_contract_numpy(pl_, pu_, po_, n_out, n_a, n_b,
                                     max_tail=max_tail, nv_cap=nv_cap,
                                     sl=sl, su=su)


def _plan_pair_contract_numpy(pl_, pu_, po_, n_out, n_a, n_b, *,
                              max_tail=0.05, nv_cap=_NV_CAP, sl=0, su=0):
    """The numpy planner (oracle for the native tier; fallback when the
    library is unavailable or ``po_`` arrives unsorted)."""
    npairs = len(po_)
    pl_ = np.asarray(pl_)
    pu_ = np.asarray(pu_)
    po_ = np.asarray(po_)
    T = -(-n_out // _OW)
    gwl, gwu = 8 << sl, 8 << su     # per-vreg window rows per operand
    # group pairs by (tile, absolute (1024<<su)-block of pu, absolute
    # (1024<<sl)-block of pl): both gather windows are then exact by
    # construction (idx = value & (block-1)), so window spills are
    # limited to vregs evicted from oversized tile windows (below) plus
    # the per-tile vreg budget.  int32 copies + early frees keep the
    # planner's footprint ~6 arrays x npairs.
    # lexsort = stable timsort per int32 key: the native pair emitters
    # produce (po, pu)-sorted lists, so the tile/ublock passes are
    # near-linear and no 64-bit composite key is materialized.
    # Stability over the po-sorted input keeps every vreg po-ascending
    # (pes/pesp load-bearing) for ANY coarsening of the group keys.
    order = np.lexsort((np.asarray(pl_, np.int32) >> (10 + sl),
                        np.asarray(pu_, np.int32) >> (10 + su),
                        np.asarray(po_, np.int32) >> 10))
    spl = np.asarray(pl_, np.int32)[order]
    spu = np.asarray(pu_, np.int32)[order]
    spo = np.asarray(po_, np.int32)[order]
    del order
    stile = spo >> 10
    sub_ = spu >> (10 + su)
    slb = spl >> (10 + sl)
    key_change = np.ones(npairs, bool)
    key_change[1:] = ((stile[1:] != stile[:-1])
                      | (sub_[1:] != sub_[:-1]) | (slb[1:] != slb[:-1]))
    # group-relative ranks via running maxima of start positions
    idx = np.arange(npairs, dtype=np.int64)
    rank_in_g = idx - np.maximum.accumulate(np.where(key_change, idx, 0))
    v_change = key_change | ((rank_in_g & 1023) == 0)
    del rank_in_g, key_change
    vid = np.cumsum(v_change) - 1
    vstart = np.flatnonzero(v_change)
    nv_total = len(vstart)
    slot = idx - np.maximum.accumulate(np.where(v_change, idx, 0))
    del v_change, idx
    v_tile = stile[vstart]
    v_ublock = sub_[vstart]
    v_lblock = slb[vstart]
    # tile segmentation of vregs (vstart order is tile-sorted)
    vt_change = np.ones(nv_total, bool)
    vt_change[1:] = v_tile[1:] != v_tile[:-1]
    vt_start = np.flatnonzero(vt_change)
    vt_cnt = np.diff(np.append(vt_start, nv_total))
    tid = np.cumsum(vt_change) - 1          # vreg -> dense tile index

    # window outliers -> tail: each tile's union gather window must fit
    # _WIN_ROWS_CAP rows per operand.  Boundary/irregular patterns (a
    # clipped dense column, a far coupling) can put a handful of vregs
    # arbitrarily far from the tile's locality center, so anchor the
    # window at the per-tile median block and spill vregs outside to the
    # COO tail (counted against max_tail) instead of rejecting the plan.
    win_ok = np.ones(nv_total, bool)
    for blocks, gw in ((v_lblock, gwl), (v_ublock, gwu)):
        capb = _WIN_ROWS_CAP // gw      # window cap in coarse blocks
        srt = np.lexsort((blocks, tid))
        med = blocks[srt[vt_start + vt_cnt // 2]]
        lo = np.maximum(med - capb // 2, 0)
        bv = blocks - lo[tid]
        win_ok &= (bv >= 0) & (bv < capb)
    # per-tile vreg index + budget over window-surviving vregs
    rank = np.zeros(nv_total, np.int64)
    ok_idx = np.flatnonzero(win_ok)
    if ok_idx.size == 0:
        return None
    tchg = np.ones(ok_idx.size, bool)
    tchg[1:] = tid[ok_idx][1:] != tid[ok_idx][:-1]
    tstart = np.flatnonzero(tchg)
    rank[ok_idx] = (np.arange(ok_idx.size)
                    - np.repeat(tstart, np.diff(np.append(tstart,
                                                          ok_idx.size))))
    NV = int(min(rank[ok_idx].max() + 1, nv_cap))
    v_live = win_ok & (rank < NV)
    spill = ~v_live[vid]
    keep = ~spill
    if spill.sum() > max_tail * npairs:
        return None
    # tile window bases / sizes (over the surviving vregs)
    live_v = np.flatnonzero(v_live)
    lbase = np.full(T, 1 << 60, np.int64)
    ubase = np.full(T, 1 << 60, np.int64)
    lmax = np.full(T, -1, np.int64)
    umax = np.full(T, -1, np.int64)
    np.minimum.at(lbase, v_tile[live_v], v_lblock[live_v] * gwl)
    np.maximum.at(lmax, v_tile[live_v], v_lblock[live_v] * gwl + gwl)
    np.minimum.at(ubase, v_tile[live_v], v_ublock[live_v] * gwu)
    np.maximum.at(umax, v_tile[live_v], v_ublock[live_v] * gwu + gwu)
    empty = lmax < 0
    lbase[empty] = 0
    ubase[empty] = 0
    lmax[empty] = gwl
    umax[empty] = gwu
    WLr = _pow2ceil(max(int((lmax - lbase).max()), gwl))
    WUr = _pow2ceil(max(int((umax - ubase).max()), gwu))
    if WLr > _WIN_ROWS_CAP or WUr > _WIN_ROWS_CAP:
        return None              # unreachable post window-spill; guard
    # pack streams (T, NV, 8, 128) int16 + per-vreg window starts
    pls = np.zeros((T, NV, _OW), np.int16)
    pus = np.zeros((T, NV, _OW), np.int16)
    pos = np.full((T, NV, _OW), _OW, np.int16)
    lq = np.zeros((T, NV), np.int32)
    uq = np.zeros((T, NV), np.int32)
    kv = live_v
    lq[v_tile[kv], rank[kv]] = (v_lblock[kv] * gwl
                                - lbase[v_tile[kv]]).astype(np.int32)
    uq[v_tile[kv], rank[kv]] = (v_ublock[kv] * gwu
                                - ubase[v_tile[kv]]).astype(np.int32)
    # single flat fancy-index per stream (multi-axis advanced indexing
    # recomputes the index triple per array)
    flat = ((stile[keep].astype(np.int64) * NV + rank[vid[keep]]) * _OW
            + slot[keep])
    pls.reshape(-1)[flat] = (spl[keep] & (gwl * LANES - 1)).astype(
        np.int16)
    pus.reshape(-1)[flat] = (spu[keep] & (gwu * LANES - 1)).astype(
        np.int16)
    pos.reshape(-1)[flat] = (spo[keep] & 1023).astype(np.int16)
    # pes: per-vreg cumulative pair count per output slot (cumsum-
    # difference scatter gather positions).  The bincount scratch is
    # O(T*NV*1024) int64 — fine at the scales the numpy planner serves.
    hist = np.bincount(
        (flat // _OW) * _OW + (spo[keep] & 1023).astype(np.int64),
        minlength=T * NV * _OW).reshape(T * NV, _OW)
    pes = np.cumsum(hist, axis=1).astype(np.int16).reshape(T * NV, _OW)
    pesp = np.zeros_like(pes)
    pesp[:, 1:] = pes[:, :-1]
    pes = pes.reshape(T, NV, _OW)
    pesp = pesp.reshape(T, NV, _OW)
    del hist, flat
    pad_rows_a = int(lbase.max()) + WLr
    pad_rows_b = int(ubase.max()) + WUr
    meta = dict(T=T, NV=NV, WLr=WLr, WUr=WUr, n_out=int(n_out),
                n_a=int(n_a), n_b=int(n_b), GWL=gwl, GWU=gwu,
                pad_rows_a=max(pad_rows_a, -(-int(n_a) // LANES)),
                pad_rows_b=max(pad_rows_b, -(-int(n_b) // LANES)))
    fill = float(npairs - spill.sum()) / (T * NV * _OW)
    nv = np.bincount(v_tile[live_v], minlength=T).astype(np.int32)
    return dict(pls=pls.reshape(T, NV, 8, LANES),
                pus=pus.reshape(T, NV, 8, LANES),
                pos=pos.reshape(T, NV, 8, LANES),
                pes=pes.reshape(T, NV, 8, LANES),
                pesp=pesp.reshape(T, NV, 8, LANES),
                lq=lq, uq=uq, nv=nv,
                lbase=lbase.astype(np.int32), ubase=ubase.astype(np.int32),
                tail=(spl[spill].astype(np.int32),
                      spu[spill].astype(np.int32),
                      spo[spill].astype(np.int32)),
                meta=tuple(sorted(meta.items())), fill=fill)


# ---------------------------------------------------------------------------
# reference tier
# ---------------------------------------------------------------------------

def _index(x, device):
    return torch.as_tensor(x, device=device).long()


@register("pair_contract", "reference")
def pair_contract_reference(a, b, pl_, pu_, po_, n_out):
    """Oracle: plain gathers + ``index_add_``."""
    pl_, pu_, po_ = (_index(t, a.device) for t in (pl_, pu_, po_))
    prod = a[pl_] * b[pu_]
    y = torch.zeros(int(n_out), dtype=prod.dtype, device=a.device)
    return y.index_add_(0, po_, prod)


def _add_tail(y, a, b, tail):
    tl, tu, to = (t.long() for t in tail)
    if tl.shape[0]:
        y.index_add_(0, to, a[tl] * b[tu])
    return y


_PLAIN_CHUNK = 1 << 24      # vreg slots per step of the plain version


def _planned_plain(a, b, arrs, meta, mode):
    """The kernels' arithmetic on the planned streams, in plain torch and
    in the value type: per tile, per live vreg, the windowed gathers
    ``a[(lbase + lq) * 128 + pls]`` and ``b[(ubase + uq) * 128 + pus]``
    from zero-padded operands and their products; then
    ``cs[pes-1] - cs[pesp-1]`` over the vreg's inclusive prefix ``cs``
    (``"cumsum_batched"``) or the products added at their slot ``pos``
    (``"onehot"``, padding at 1024 skipped), summed over the tile's vregs
    in order; then the COO tail."""
    T, NV = meta["T"], meta["NV"]
    dev = a.device
    ap = torch.zeros(meta["pad_rows_a"] * LANES, dtype=a.dtype, device=dev)
    ap[:a.shape[0]] = a
    bp = torch.zeros(meta["pad_rows_b"] * LANES, dtype=b.dtype, device=dev)
    bp[:b.shape[0]] = b
    live = (torch.arange(NV, device=dev)[None, :]
            < arrs["nv"].long()[:, None])                       # (T, NV)
    abase = (arrs["lbase"].long()[:, None] + arrs["lq"].long()) * LANES
    bbase = (arrs["ubase"].long()[:, None] + arrs["uq"].long()) * LANES
    streams = ("pes", "pesp") if mode == "cumsum_batched" else ("pos",)
    y = torch.zeros((T, _OW), dtype=torch.result_type(a, b), device=dev)
    step = max(1, _PLAIN_CHUNK // (NV * _OW))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        sl = slice(t0, t1)
        pls = arrs["pls"][sl].reshape(t1 - t0, NV, _OW).long()
        pus = arrs["pus"][sl].reshape(t1 - t0, NV, _OW).long()
        p = ap[abase[sl][..., None] + pls] * bp[bbase[sl][..., None] + pus]
        lv = live[sl]
        if mode == "cumsum_batched":
            cs = torch.nn.functional.pad(p.cumsum(-1), (1, 0))  # cs[-1] = 0
            pes, pesp = (arrs[s][sl].reshape(t1 - t0, NV, _OW).long()
                         for s in streams)
            d = cs.gather(-1, pes) - cs.gather(-1, pesp)
            acc = y[sl]
            for v in range(NV):
                acc += torch.where(lv[:, v, None], d[:, v], 0)
        else:
            pos = arrs["pos"][sl].reshape(t1 - t0, NV, _OW).long()
            ok = (pos < _OW) & lv[..., None]
            rows = torch.arange(t0, t1, device=dev)[:, None, None] * _OW
            y.view(-1).index_add_(0, (rows + pos)[ok], p[ok])
    y = y.reshape(-1)[:meta["n_out"]]
    return _add_tail(y, a, b, arrs["tail"])


@register("pair_contract_planned", "reference")
def pair_contract_planned_reference(a, b, arrs, meta_items):
    """Reference consumption of a kernel plan: the raw triple when
    ``arrs['raw']`` is present, else the plain version of the kernels on
    the planned streams of the active ``_DOT_MODE``."""
    meta = dict(meta_items)
    if "raw" in arrs:
        rl, ru, ro = arrs["raw"]
        return pair_contract_reference(a, b, rl, ru, ro, meta["n_out"])
    assert _DOT_MODE in ("onehot", "cumsum_batched"), _DOT_MODE
    return _planned_plain(a, b, arrs, meta, _DOT_MODE)


# ---------------------------------------------------------------------------
# the pad-free pair stream of the cuda tier
# ---------------------------------------------------------------------------

STREAM = ("cl", "cu", "co", "vstart", "va", "vb", "tstart")
TAIL = ("tl", "tu", "tseg", "tpo")
_CHUNK = 8                  # pairs a lane of the kernels loads at once


def pair_stream(arrs, meta_items):
    """The pad-free pair stream of a kernel plan, built on the device of
    its slab arrays (``pls``, ``pus``, ``pos`` (T, NV, 8, 128) int16 and
    the ``lq``/``uq``/``nv``/``lbase``/``ubase`` tables):

    - the live vregs (``v < nv[t]``) in (tile, vreg) order; live vreg i's
      pairs at ``[vstart[i], vstart[i+1])`` (``vstart`` int64), its range
      padded to a multiple of 8 (the kernels' 16-byte loads) with pairs of
      slot 1024, which add nothing;
    - its pairs: the slots with ``pos < 1024``, in slot order (so
      po-ascending, as kernel D's segmented sum needs);
    - ``cl``/``cu``/``co``: each pair's ``pls``, ``pus`` and ``pos``;
    - ``va``/``vb`` int32: the vreg's window rows ``lbase[t] + lq[t, v]``
      and ``ubase[t] + uq[t, v]``;
    - ``tstart`` int32 (T + 1): tile t's live vregs are ``[tstart[t],
      tstart[t+1])``;
    - the plan's COO tail ``arrs["tail"]`` sorted by po (stable): ``tl``,
      ``tu`` int32, and for each of its output slots ``tpo`` its pairs
      ``[tseg[i], tseg[i+1])``."""
    meta = dict(meta_items)
    T, NV = meta["T"], meta["NV"]
    dev = arrs["pls"].device
    nv = arrs["nv"].long()
    live = torch.arange(NV, device=dev)[None, :] < nv[:, None]  # (T, NV)
    pos = arrs["pos"].reshape(T, NV, _OW)
    keep = (pos >= 0) & (pos < _OW) & live[..., None]
    count = keep.sum(-1)[live]
    flat = keep.reshape(-1).nonzero().squeeze(1)       # (tile, vreg, slot)
    del keep
    nvr = count.numel()
    vreg = torch.repeat_interleave(torch.arange(nvr, device=dev), count,
                                   output_size=flat.numel())
    vstart = torch.zeros(nvr + 1, dtype=torch.int64, device=dev)
    torch.cumsum(-(-count // _CHUNK) * _CHUNK, 0, out=vstart[1:])
    total = int(vstart[-1])
    if total >= 1 << 31:
        raise ValueError(f"pair_stream: {total} pairs do not fit the "
                         f"kernels' int32 tables")
    first = torch.cumsum(count, 0) - count
    dest = vstart[vreg] + torch.arange(flat.numel(), device=dev) - first[vreg]
    del vreg, first
    out = {}
    for name, src, fill in (("cl", arrs["pls"], 0), ("cu", arrs["pus"], 0),
                            ("co", pos, _OW)):
        out[name] = torch.full((total,), fill, dtype=torch.int16,
                               device=dev)
        out[name][dest] = src.reshape(-1)[flat]
    tile, rank = live.nonzero(as_tuple=True)
    tstart = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    torch.cumsum(nv, 0, out=tstart[1:])
    out.update(vstart=vstart, tstart=tstart,
               va=(arrs["lbase"][tile] + arrs["lq"][tile, rank]).int(),
               vb=(arrs["ubase"][tile] + arrs["uq"][tile, rank]).int())
    tl, tu, to = (t.to(dev).long() for t in arrs["tail"])
    order = torch.sort(to, stable=True).indices
    tpo, count = torch.unique_consecutive(to[order], return_counts=True)
    tseg = torch.zeros(tpo.numel() + 1, dtype=torch.int32, device=dev)
    torch.cumsum(count, 0, out=tseg[1:])
    out.update(tl=tl[order].int(), tu=tu[order].int(), tseg=tseg,
               tpo=tpo.int())
    return out


# ---------------------------------------------------------------------------
# cuda tier: kernels D and E of csrc/pair_contract.cu
# ---------------------------------------------------------------------------

def _launch(kernel, mode, a, b, arrs, meta_items):
    meta = dict(meta_items)
    T, n_out = meta["T"], meta["n_out"]
    if a.dtype.is_complex or b.dtype.is_complex:
        raise NotImplementedError(
            "pair_contract kernels take f32 or f64 values; the TPU kernels "
            "take f32 only, so no kernel computes the complex contraction "
            "(ROADMAP.md queue 3, the divergence \"D and E in f64\")")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pair_contract kernels take f32 or f64 operands of "
                        f"one type, got {a.dtype} and {b.dtype}")
    if "stream" not in arrs:
        raise ValueError("pair_contract: the kernels read the plan's pad-free "
                         "pair stream; build it with pair_stream(arrs, meta)")
    st = arrs["stream"]
    nvr = st["va"].shape[0] if st["va"].ndim == 1 else -1
    nseg = st["tpo"].shape[0] if st["tpo"].ndim == 1 else -1
    if (a.ndim != 1 or b.ndim != 1
            or a.shape[0] > meta["pad_rows_a"] * LANES
            or b.shape[0] > meta["pad_rows_b"] * LANES
            or n_out > T * _OW
            or any(st[k].ndim != 1 or st[k].dtype != torch.int16
                   or st[k].shape != st["cl"].shape
                   for k in ("cl", "cu", "co"))
            or st["cl"].shape[0] % _CHUNK
            or st["vstart"].dtype != torch.int64
            or tuple(st["vstart"].shape) != (nvr + 1,)
            or any(st[k].dtype != torch.int32 for k in ("va", "vb",
                                                        "tstart"))
            or tuple(st["vb"].shape) != (nvr,)
            or tuple(st["tstart"].shape) != (T + 1,)
            or any(st[k].dtype != torch.int32 for k in TAIL)
            or st["tl"].ndim != 1 or st["tu"].shape != st["tl"].shape
            or tuple(st["tseg"].shape) != (nseg + 1,)):
        raise ValueError(
            f"pair_contract: a {tuple(a.shape)}, b {tuple(b.shape)}, stream "
            f"{ {k: (tuple(v.shape), v.dtype) for k, v in st.items()} } do "
            f"not fit meta {meta}")
    tensors = [a, b, *(st[k] for k in STREAM + TAIL)]
    if any(t.device != a.device for t in tensors):
        raise ValueError("pair_contract: plan and operands must share one "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pair_contract: plan and operands must be "
                         "contiguous")
    y = torch.empty(n_out, dtype=a.dtype, device=a.device)
    lib = _cuda.library("pair_contract")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.pair_contract_launch(
            mode, _cuda.type_code(a.dtype), a.data_ptr(), a.shape[0],
            b.data_ptr(), b.shape[0],
            *(st[k].data_ptr() for k in STREAM), T, n_out,
            *(st[k].data_ptr() for k in TAIL), nseg, y.data_ptr(), stream)
        _cuda.check("pair_contract", code)
        kernel.launches += 1
    return y


def pair_contract_cumsum_cuda(a, b, arrs, meta_items):
    """Kernel D, the deterministic segmented sum (``_DOT_MODE =
    "cumsum_batched"``), COO tail included.  A tensor on the CPU takes the
    plain version on the plan's slabs; on a CUDA device this launches the
    kernel on ``arrs["stream"]`` or raises — it never falls back."""
    if a.device.type != "cuda":
        return _planned_plain(a, b, arrs, dict(meta_items), "cumsum_batched")
    return _launch(pair_contract_cumsum_cuda, 0, a, b, arrs, meta_items)


def pair_contract_onehot_cuda(a, b, arrs, meta_items):
    """Kernel E, the slot scatter by shared atomics (``_DOT_MODE =
    "onehot"``), COO tail included; CPU tensors take the plain version, as
    kernel D's."""
    if a.device.type != "cuda":
        return _planned_plain(a, b, arrs, dict(meta_items), "onehot")
    return _launch(pair_contract_onehot_cuda, 1, a, b, arrs, meta_items)


# kernel launches since the last reset
pair_contract_cumsum_cuda.launches = 0
pair_contract_onehot_cuda.launches = 0


@register("pair_contract_planned", "cuda")
def pair_contract_planned_cuda(a, b, arrs, meta_items):
    """The planned contraction on the kernel of the active ``_DOT_MODE``."""
    if "raw" in arrs:
        raise ValueError("pair_contract: a raw-triple plan has no kernel "
                         "streams; contract it through 'pair_contract'")
    if _DOT_MODE == "cumsum_batched":
        return pair_contract_cumsum_cuda(a, b, arrs, meta_items)
    if _DOT_MODE == "onehot":
        return pair_contract_onehot_cuda(a, b, arrs, meta_items)
    raise ValueError(f"unknown pair_contract _DOT_MODE {_DOT_MODE!r}")
