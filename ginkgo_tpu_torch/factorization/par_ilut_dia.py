"""Device ParILUT/ParICT for diagonal-structured matrices
(``ginkgo_tpu/factorization/par_ilut_dia.py`` in torch).

The reference keeps L and U as dense diagonal (DIA) slabs ``(ND, n)`` over
a fixed *offset universe* (the two-level closure of A's offsets, capped)
and runs the whole ParILUT loop on the device; the pattern evolves as a
uint8 mask over the slab, so every outer iteration has the same shapes:

* ``plan_dia`` / ``plan_dia_ict`` (host numpy, verbatim) pick the
  universe, or decline a matrix that is not diagonal-structured (then
  ``ParIlut(algorithm="auto")`` goes on to the packed path);
* ``_product``: C = (I+L)·U restricted to the universe, and the product
  pattern on the masks.  For offsets ``ol + ou = oc`` the term is
  ``C[oc, i] += L[ol, i] * U[ou, i + ol]``.  The reference sums it as
  one-hot matmuls on the TPU's MXU (4 lower offsets a scan step); here it
  is one shifted multiply-add per lower offset, batched over the upper
  offsets whose sum lands in the universe (``_terms``), added with
  ``index_add_`` (the targets of one lower offset are distinct, so the
  sums are deterministic).  The one-hot form adds exact zeros besides,
  so only the order of the sums differs;
* ``_topk_mask`` (threshold select: top-k by a 32-step bisection over
  sortable-bit keys with a deterministic slot-hash tie jitter) and
  ``_compact_device`` (stable stream compaction), which the packed loop of
  ``par_ilut_packed.py`` uses as well;
* ``_run_dia``: 3 scaled-start Jacobi sweeps, then ``iterations`` ×
  (candidates → select → filter → ``sweeps``), with no host sync inside;
* ParICT on the lower universe only (``_run_dia_ict``): the product is
  L·Lᴴ against the mirrored slab ``U[b, m] = conj(L[b, m - o_b])``, and
  the IC sweep takes the diagonal's square root.

The arithmetic stays in the factor's dtype (f32 in f32: no matmul, so no
TF32); complex values take the same code.  ``generate_dia`` /
``generate_dia_ict`` return None where the plan declines.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import stagetimer


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




# ---------------------------------------------------------------------------
# slab helpers
# ---------------------------------------------------------------------------

def _dia_slab_device(values, p, rows, nd, n):
    """The (nd, n) slab from COO triplets, scattered on the values'
    device: ships nnz*(value + 4 + 4) bytes instead of the dense slab."""
    AV = torch.zeros((nd, n), dtype=values.dtype, device=values.device)
    AV[p.long(), rows.long()] = values
    return AV


def _shifted_rows(X, offs, pad):
    """Row a of the result is row r = offs[a, 0] of X shifted by s =
    offs[a, 1] (|s| <= pad): y[a, i] = X[r, i + s] where 0 <= i + s < n,
    else 0.  One gather from the zero-padded slab's sliding windows."""
    n = X.shape[-1]
    win = F.pad(X, (pad, pad)).unfold(-1, n, 1)      # (R, 2 pad + 1, n)
    return win[offs[:, 0], pad + offs[:, 1]]


def _terms(targets, universe):
    """The product's terms by first-factor row, on the host: for each row
    a whose offset sums into the universe with any second-factor row, (a,
    those rows u, their targets' universe rows t) (``targets[a, u]`` is
    the offset of the term's product)."""
    ND = universe.size
    tpos = np.searchsorted(universe, targets)
    tpos_c = np.minimum(tpos, ND - 1)
    valid = universe[tpos_c] == targets
    out = []
    for a in range(targets.shape[0]):
        u = np.flatnonzero(valid[a])
        if u.size:
            out.append((a, u, tpos_c[a, u]))
    return out


def _ship_terms(terms, ols, device):
    """The terms on ``device`` in one transfer: [(a, offset, u, t)]."""
    if not terms:
        return []
    sizes = [u.size for _, u, _ in terms]
    flat = torch.from_numpy(np.concatenate(
        [np.concatenate([u for _, u, _ in terms]),
         np.concatenate([t for _, _, t in terms])])).to(device)
    us = torch.split(flat[:sum(sizes)], sizes)
    ts = torch.split(flat[sum(sizes):], sizes)
    return [(a, int(ols[a]), u, t)
            for (a, _, _), u, t in zip(terms, us, ts)]


def _accumulate(C, X, Ypad, terms, pad):
    """C[t] += X[a] * Ypad[u, pad + o_a : pad + o_a + n] for each term
    (a, o_a, u, t); Ypad is the second factor's slab zero-padded by
    ``pad`` on both sides, so the shifted rows come out of one gather."""
    n = C.shape[1]
    for a, o, u, t in terms:
        P = Ypad[u, pad + o:pad + o + n]
        P.mul_(X[a])
        C.index_add_(0, t, P)
    return C


def _product(V, M, terms, n_low, pad, want_mask):
    """C = (I+L)@U on the slab; optionally the product pattern mask.

    V: (ND, n) values (inactive slots MUST be zero), M: (ND, n) uint8.
    Rows [0, n_low) are the strictly-lower offsets, row n_low the main
    diagonal, the rest upper; ``terms`` pairs each lower row with the
    upper rows its offset sums into the universe with (``_terms``);
    pad = max |offset|."""
    VU = V[n_low:]
    C = torch.zeros_like(V)
    C[n_low:] = VU                                       # I @ U seed
    _accumulate(C, V, F.pad(VU, (pad, pad)), terms, pad)
    if not want_mask:
        return C, None
    MUf = M[n_low:].to(torch.float32)
    Cm = torch.zeros(V.shape, dtype=torch.float32, device=V.device)
    Cm[n_low:] = MUf
    _accumulate(Cm, M.to(torch.float32), F.pad(MUf, (pad, pad)), terms, pad)
    return C, (Cm > 0.5).to(torch.uint8)


def _nonzero_or_one(D):
    return torch.where(D == 0, torch.ones((), dtype=D.dtype,
                                          device=D.device), D)


def _lower_den(V, den_offs, n_low, pad):
    """u_jj aligned to each lower diagonal: den[a, i] = u[i+ol_a, i+ol_a]
    (``den_offs``: the (0, ol_a) pairs of ``_shifted_rows``)."""
    if n_low == 0:
        return V[:0]
    return _nonzero_or_one(_shifted_rows(V[n_low:n_low + 1], den_offs, pad))


def _run_dia(AV, terms, den_offs, n_low, pad, iterations, sweeps, keep_l,
             keep_u):
    """The whole ParILUT loop on the device of ``AV``: init sweeps +
    ``iterations`` x (candidates -> select -> filter -> sweeps).  Returns
    (V, M)."""
    zero = torch.zeros((), dtype=AV.dtype, device=AV.device)
    Am = (AV != 0).to(torch.uint8)
    Am[n_low] = 1

    def jacobi(V, C):
        """The Chow-Patel update: l += (A - LU)/u_jj, u += (A - LU)."""
        R = AV - C
        D = _lower_den(V, den_offs, n_low, pad)
        return V + torch.cat([R[:n_low] / D, R[n_low:]], dim=0)

    def sweep_block(V, M, count):
        for _ in range(count):
            C, _ = _product(V, M, terms, n_low, pad, want_mask=False)
            V = torch.where(M.bool(), jacobi(V, C), zero)
        return V

    def iteration(V, M):
        # 1+2. product + add_candidates + Jacobi seed on the union
        C, Cm = _product(V, M, terms, n_low, pad, want_mask=True)
        cand = torch.maximum(Cm, Am)
        V2 = torch.where(cand.bool(), jacobi(V, C), zero)
        # 3+4. select + filter: top-k by magnitude per factor (diagonal
        # pinned to +inf so it is always kept within budget)
        mag = V2.abs()
        mag_u = mag[n_low:].clone()
        mag_u[0] = float("inf")
        M3 = torch.cat([_topk_mask(mag[:n_low], cand[:n_low], keep_l),
                        _topk_mask(mag_u, cand[n_low:], keep_u)], dim=0)
        M3[n_low] = 1
        # 5. sweeps on the filtered pattern
        return sweep_block(V2 * M3, M3, sweeps), M3

    den0 = _lower_den(AV, den_offs, n_low, pad)
    V0 = torch.cat([AV[:n_low] / den0, AV[n_low:]], dim=0) * Am
    carry = (sweep_block(V0, Am, 3), Am)
    for _ in range(iterations):
        carry = iteration(*carry)
    return carry


def _ship_slab(vals, p, rows, nd, n, device):
    """A's slab on ``device`` from host COO triplets (the transfer stage)."""
    with stagetimer.stage("transfer"):
        put = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
               for x in (vals, p, rows)]
        return stagetimer.sync(_dia_slab_device(*put, nd, n))


def _pull(V, M, kmax):
    """Device compaction of the masked slab, then one small pull: (flat
    slab index, value) host arrays of the kept slots."""
    with stagetimer.stage("device"):
        vals, slots, count = stagetimer.sync(_compact_device(V, M, kmax))
    with stagetimer.stage("transfer"):
        nk = int(count)
        return (slots.cpu().numpy()[:nk].astype(np.int64),
                vals.cpu().numpy()[:nk])


def generate_dia(d, iterations, fill_in_limit, sweeps, *, cap=384,
                 device="cpu"):
    """Run the DIA ParILUT on ``device``; returns (lr, lc, lv, ur, uc, uv)
    split host arrays (L strictly lower) or None when the matrix is not
    diagonal-structured.  ``d`` is canonical and left unchanged."""
    plan = plan_dia(d, cap=cap)
    if plan is None:
        return None
    device = torch.device(device)
    universe, n_low = plan["universe"], plan["n_low"]
    n = d.shape[0]
    ND = universe.size
    off = d.col_idx.astype(np.int64) - d.row_idx
    p = np.searchsorted(universe, off)
    AV = _ship_slab(d.values, p, d.row_idx.astype(np.int64), ND, n, device)

    # static budgets from A's split pattern (diag always present in U)
    low = d.row_idx > d.col_idx
    nnz_l0 = int(low.sum())
    nnz_u0 = int((~low & (d.values != 0)).sum())
    nnz_u0 += n - int(((d.row_idx == d.col_idx) & (d.values != 0)).sum())
    keep_l = int(np.ceil(fill_in_limit * max(nnz_l0, 1)))
    keep_u = int(np.ceil(fill_in_limit * max(nnz_u0, 1)))

    ols = universe[:n_low]
    terms = _terms(ols[:, None] + universe[None, n_low:], universe)
    pad = int(max(np.abs(universe).max(), 1))
    with stagetimer.stage("transfer"):
        dterms = _ship_terms(terms, ols, device)
        den_offs = torch.from_numpy(np.stack(
            [np.zeros(n_low, np.int64), ols], axis=1)).to(device)
        stagetimer.sync((AV, den_offs))
    with stagetimer.stage("device"):
        V, M = _run_dia(AV, dterms, den_offs, n_low, pad, int(iterations),
                        int(sweeps), keep_l, keep_u)
    flat, v = _pull(V, M, keep_l + keep_u + n)
    p, r = np.divmod(flat, n)
    off = universe[p]
    c = r + off
    lowm = off < 0
    return (r[lowm], c[lowm], v[lowm],
            r[~lowm], c[~lowm], v[~lowm])


# ---------------------------------------------------------------------------
# ParICT on diagonal slabs (A SPD/HPD, factor A ~= L L^H)
# ---------------------------------------------------------------------------
# Only the lower universe is stored (offsets <= 0 ascending, the diagonal
# the LAST row).  The product L @ L^H is the ILUT product against the
# MIRRORED slab U[b, m] = conj(L[b, m - o_b]) (L^H realigned to
# diagonals), and the Chow-Patel IC sweep updates are
#   l_ij += (A - L L^H)_ij / conj(l_jj)      (off-diagonal)
#   l_jj  = sqrt(|l_jj|^2 + Re(A - L L^H)_jj) (diagonal).

def _product_ict(V, M, terms, mirror_offs, pad, want_mask):
    """C = tril(L @ L^H) on the lower slab; ``terms`` pairs row a with the
    rows b whose offset difference o_a - o_b lies in the universe."""
    Upad = F.pad(_shifted_rows(torch.conj(V).resolve_conj(), mirror_offs,
                               pad), (pad, pad))
    C = _accumulate(torch.zeros_like(V), V, Upad, terms, pad)
    if not want_mask:
        return C, None
    Mf = M.to(torch.float32)
    Mpad = F.pad(_shifted_rows(Mf, mirror_offs, pad), (pad, pad))
    Cm = _accumulate(torch.zeros_like(Mf), Mf, Mpad, terms, pad)
    return C, (Cm > 0.5).to(torch.uint8)


def _run_dia_ict(AV, terms, mirror_offs, den_offs, pad, iterations, sweeps,
                 keep_n):
    """The whole ParICT loop on the device of ``AV``; returns (V, M)."""
    rdt = torch.real(AV).dtype
    tiny = torch.tensor(torch.finfo(rdt).tiny, dtype=rdt, device=AV.device)
    Am = (AV != 0).to(torch.uint8)
    Am[-1] = 1

    def ict_den(V):
        """l_jj aligned to each lower diagonal (the diagonal is V[-1])."""
        return _nonzero_or_one(_shifted_rows(V[-1:], den_offs, pad))

    def ic_update(V, R):
        D = ict_den(V)
        off = V[:-1] + R[:-1] / torch.conj(D[:-1])
        dsq = torch.real(V[-1] * torch.conj(V[-1])) + torch.real(R[-1])
        dnew = torch.sqrt(torch.maximum(dsq, tiny))
        return torch.cat([off, dnew[None, :].to(V.dtype)], dim=0)

    def sweep_block(V, M, count):
        for _ in range(count):
            C, _ = _product_ict(V, M, terms, mirror_offs, pad, False)
            V = ic_update(V, (AV - C) * M) * M
        return V

    def iteration(V, M):
        C, Cm = _product_ict(V, M, terms, mirror_offs, pad, True)
        cand = torch.maximum(Cm, Am)
        cand[-1] = 1
        V2 = ic_update(V, (AV - C) * cand) * cand
        mag = V2.abs()
        mag[-1] = float("inf")
        M3 = _topk_mask(mag, cand, keep_n)
        M3[-1] = 1
        return sweep_block(V2 * M3, M3, sweeps), M3

    # scaled init: l_jj = sqrt(|a_jj|), l_ij = a_ij / l_jj
    d0 = torch.sqrt(AV[-1].abs())
    d0 = torch.where(d0 == 0, torch.ones((), dtype=rdt, device=AV.device),
                     d0).to(AV.dtype)
    A0 = AV.clone()
    A0[-1] = d0
    den0 = ict_den(A0)
    V0 = torch.cat([AV[:-1] / torch.conj(den0[:-1]), d0[None, :]], dim=0)
    carry = (sweep_block(V0 * Am, Am, 3), Am)
    for _ in range(iterations):
        carry = iteration(*carry)
    return carry


def generate_dia_ict(d, iterations, fill_in_limit, sweeps=1, *, cap=256,
                     device="cpu"):
    """Run the DIA ParICT on ``device``; returns (lr, lc, lv) of the lower
    factor (diagonal included) or None when not diagonal-structured."""
    plan = plan_dia_ict(d, cap=cap)
    if plan is None:
        return None
    device = torch.device(device)
    universe = plan["universe"]
    n = d.shape[0]
    ND = universe.size
    lowm = d.row_idx >= d.col_idx
    offl = d.col_idx[lowm].astype(np.int64) - d.row_idx[lowm]
    pl = np.searchsorted(universe, offl)
    AV = _ship_slab(d.values[lowm], pl, d.row_idx[lowm].astype(np.int64),
                    ND, n, device)
    terms = _terms(universe[:, None] - universe[None, :], universe)
    pad = int(max(np.abs(universe).max(), 1))
    nnz_low = int(lowm.sum()) + n - int(
        ((d.row_idx == d.col_idx) & lowm).sum())
    keep_n = int(np.ceil(fill_in_limit * max(nnz_low, 1)))
    rows = np.arange(ND, dtype=np.int64)
    with stagetimer.stage("transfer"):
        dterms = _ship_terms(terms, universe, device)
        mirror_offs = torch.from_numpy(np.stack(
            [rows, -universe], axis=1)).to(device)
        den_offs = torch.from_numpy(np.stack(
            [np.zeros(ND, np.int64), universe], axis=1)).to(device)
        stagetimer.sync((AV, mirror_offs, den_offs))
    with stagetimer.stage("device"):
        V, M = _run_dia_ict(AV, dterms, mirror_offs, den_offs, pad,
                            int(iterations), int(sweeps), keep_n)
    flat, v = _pull(V, M, keep_n + n)
    p, r = np.divmod(flat, n)
    return r, r + universe[p], v
