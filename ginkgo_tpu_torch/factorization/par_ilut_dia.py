"""Device ParILUT/ParICT for diagonal-structured matrices: the parts the
packed path shares (``ginkgo_tpu/factorization/par_ilut_dia.py`` in torch).

The reference reformulation keeps L and U as dense diagonal slabs over a
fixed *offset universe* (the two-level closure of A's offsets) and runs
the whole ParILUT loop on the device.  Ported so far:

* ``plan_dia`` / ``plan_dia_ict`` (host numpy, verbatim), so that
  ``ParIlut(algorithm="auto")`` routes exactly as the reference does: the
  DIA loop is tried first and declines unstructured matrices;
* ``_topk_mask`` (threshold select: top-k by a 32-step bisection over
  sortable-bit keys with a deterministic slot-hash tie jitter) and
  ``_compact_device`` (stable stream compaction), which the packed loop
  of ``par_ilut_packed.py`` uses.

The device DIA loop itself (``_run_dia``/``_run_dia_ict``: plain tensor
code, no TPU kernel) is still to be ported: ``generate_dia`` and
``generate_dia_ict`` return None where the plan declines, as the
reference does, and raise ``NotImplementedError`` where it accepts.
"""

from __future__ import annotations

import numpy as np
import torch

_DIA_TODO = ("the device DIA ParILUT/ParICT loop (par_ilut_dia.py "
             "_run_dia/_run_dia_ict) is still to be ported (ROADMAP.md "
             "queue 1 item 10); use algorithm='packed' or 'general'")


def plan_dia(d, *, cap: int = 384, max_slots: int = 200_000_000):
    """Offset-universe plan for the device ParILUT, or None when the
    matrix is not diagonal-structured enough to pay.

    Returns dict(universe=int64[ND] ascending (0 included), n_low=int).
    """
    n, m = d.shape
    if n != m or d.nnz == 0 or n < 2:
        return None
    oa = np.unique(d.col_idx.astype(np.int64) - d.row_idx.astype(np.int64))
    if oa.size > 64:                      # not diagonal-structured
        return None
    tier0 = np.union1d(oa, [0])
    lo0 = tier0[tier0 < 0]
    up0 = tier0[tier0 >= 0]
    s1 = np.unique(lo0[:, None] + up0[None, :]).ravel()
    lo1 = np.union1d(lo0, s1[s1 < 0])
    up1 = np.union1d(up0, s1[s1 >= 0])
    s2 = np.unique(lo1[:, None] + up1[None, :]).ravel()
    universe = np.union1d(np.union1d(tier0, s1), s2)
    universe = universe[(universe > -n) & (universe < n)]
    if universe.size > cap:
        # priority: A's offsets, then level-1 fill, then level-2, each
        # tier by |offset| ascending (closest-to-diagonal first)
        tiers = (tier0, np.setdiff1d(s1, tier0),
                 np.setdiff1d(s2, np.union1d(s1, tier0)))
        chosen = []
        room = cap
        for t in tiers:
            t = t[(t > -n) & (t < n)]
            if t.size > room:
                t = t[np.argsort(np.abs(t), kind="stable")[:room]]
            chosen.append(t)
            room -= t.size
            if room <= 0:
                break
        universe = np.unique(np.concatenate(chosen))
    if tier0.size > cap or universe.size * n > max_slots:
        return None
    return {"universe": universe.astype(np.int64),
            "n_low": int((universe < 0).sum())}


def plan_dia_ict(d, *, cap: int = 256, max_slots: int = 200_000_000):
    """Lower-triangular offset-universe plan (0 included, ascending, all
    offsets <= 0 so the diagonal is the LAST row), or None."""
    n, m = d.shape
    if n != m or d.nnz == 0 or n < 2:
        return None
    off = d.col_idx.astype(np.int64) - d.row_idx.astype(np.int64)
    oa = np.unique(off[off <= 0])
    if oa.size > 64:
        return None
    tier0 = np.union1d(oa, [0])
    s1 = np.unique(tier0[:, None] - tier0[None, :]).ravel()
    u1 = np.union1d(tier0, s1[s1 <= 0])
    s2 = np.unique(u1[:, None] - u1[None, :]).ravel()
    universe = np.union1d(u1, s2[s2 <= 0])
    universe = universe[universe > -n]
    if universe.size > cap:
        tiers = (tier0, np.setdiff1d(u1, tier0),
                 np.setdiff1d(universe, u1))
        chosen = []
        room = cap
        for t in tiers:
            t = t[t > -n]
            if t.size > room:
                t = t[np.argsort(np.abs(t), kind="stable")[:room]]
            chosen.append(t)
            room -= t.size
            if room <= 0:
                break
        universe = np.unique(np.concatenate(chosen))
    if tier0.size > cap or universe.size * n > max_slots:
        return None
    return {"universe": universe.astype(np.int64)}


def _compact_device(V, M, kmax):
    """Stable stream-compaction of the masked values into a static
    (kmax,) buffer: (values, flat slot index int32, count).  Slots past
    ``kmax`` are dropped, as the reference's ``mode="drop"`` scatter
    drops them; ``count`` still counts every active slot."""
    flat = M.reshape(-1)
    sel = torch.nonzero(flat == 1).squeeze(1)[:kmax]    # ascending: stable
    vals = torch.zeros(kmax, dtype=V.dtype, device=V.device)
    vals[:sel.shape[0]] = V.reshape(-1)[sel]
    slots = torch.zeros(kmax, dtype=torch.int32, device=V.device)
    slots[:sel.shape[0]] = sel.to(torch.int32)
    return vals, slots, flat.to(torch.int32).sum()


_U32 = 0xFFFFFFFF


def _topk_mask(mag, active, k):
    """Top-k mask of mag over active slots (k static), AT MOST k kept.

    A plain magnitude threshold keeps every tie — on stencils where
    magnitudes repeat that blows the fill budget — so ties are first
    broken by a deterministic slot-hash jitter (relative 2^-10 scale:
    reorders only near-equal magnitudes, which threshold selection
    treats as interchangeable anyway).  The k-th key is then found by
    32 bisection steps on count(key > t): O(N) streaming passes instead
    of an O(N log N) device sort, with the invariant count(> hi) <= k so
    the budget can never overshoot.  Zero-magnitude ties may all drop.

    The reference computes the keys in uint32; torch has no full uint32
    arithmetic, so the hash, the sortable-bit flip and the bisection run
    in int64 with explicit 32-bit masks, and ``lo``/``hi`` stay device
    tensors (no host sync in the loop).  The slots kept are exactly the
    reference's."""
    if k <= 0:
        return torch.zeros(mag.shape, dtype=torch.uint8, device=mag.device)
    size = mag.numel()
    act = active.reshape(-1).bool()
    if k >= size:
        return active.to(torch.uint8)
    dev = mag.device
    big = torch.tensor(float(np.finfo(np.float32).max) / 8,
                       dtype=torch.float32, device=dev)
    m32 = torch.minimum(mag.abs().to(torch.float32).reshape(-1), big)
    slot = torch.arange(size, dtype=torch.int64, device=dev)
    u = (((slot * 2654435761) & _U32) >> 9).to(torch.float32)
    keyf = m32 * (1.0 + u * 2.0 ** -33)                  # f32 throughout
    keyf = torch.where(act, keyf, torch.tensor(-1.0, device=dev))
    # bisect in the monotone sortable-bit space (magnitudes span ~40
    # decades from zero to the pinned diagonal — a linear float
    # bisection cannot cross that in bounded steps; 32 integer steps
    # resolve it exactly)
    bits = keyf.view(torch.int32).to(torch.int64) & _U32
    neg = (bits >> 31).bool()
    key = bits ^ torch.where(neg, torch.tensor(_U32, device=dev),
                             torch.tensor(0x80000000, device=dev))
    lo = torch.zeros((), dtype=torch.int64, device=dev)
    hi = torch.full((), _U32, dtype=torch.int64, device=dev)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        take = (key > mid).sum() > k
        lo = torch.where(take, mid, lo)
        hi = torch.where(take, hi, mid)
    keep = (key > hi) & act
    return keep.reshape(mag.shape).to(torch.uint8)


def generate_dia(d, iterations, fill_in_limit, sweeps, *, cap=384):
    """None when the matrix is not diagonal-structured (the reference's
    decline); the device DIA loop that runs otherwise is not ported yet."""
    if plan_dia(d, cap=cap) is None:
        return None
    raise NotImplementedError(_DIA_TODO)


def generate_dia_ict(d, iterations, fill_in_limit, sweeps=1, *, cap=256):
    """None when not diagonal-structured; else not ported yet (see
    ``generate_dia``)."""
    if plan_dia_ict(d, cap=cap) is None:
        return None
    raise NotImplementedError(_DIA_TODO)
