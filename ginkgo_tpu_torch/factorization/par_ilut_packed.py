"""Device-resident ParILUT/ParICT for general unstructured matrices
(``ginkgo_tpu/factorization/par_ilut_packed.py`` in torch).

The reference runs the whole ParILUT loop on the device for ANY sparsity
(``common/cuda_hip/factorization/par_ilut_{spgeam,select,filter,sweep}_
kernels.cpp``, outer loop ``core/factorization/par_ilut.cpp:262-350``) by
reallocating per iteration.  This reformulation fixes the *slot
universe* up front instead:

* The slot universe is the bounded symbolic closure of A's pattern
  (``level`` rounds of pattern ∪ pattern(tril @ triu) — the ILU(level)
  fill pattern), split into row-major strictly-lower L slots and
  upper-with-diag U slots.  Values live as flat device vectors
  ``Vl (nl,)``, ``Vu (nu,)`` with uint8 activity masks; the pattern
  evolves as a mask, never as a reallocation.
* Every product/sweep/candidate step is the **pair-contraction
  primitive** (``ops/pair_contract.py``): contribution pairs with
  ``k < min(i, j)`` are enumerated once on the host (native
  ``gt_ilut_pairs_rowmajor``), and one fixed-point evaluation is
  ``contrib = Σ Vl[pl] * Vu[pu]`` → ``l = (a - contrib)/u_jj``,
  ``u = a - contrib`` — the ParILU Jacobi update, the same semantics as
  the reference's benignly-racing parallel GPU sweeps.  The same pair
  plan evaluated on the masks yields the candidate pattern
  (``add_candidates``); ``u_jj`` per L slot is a one-pair-per-output
  contraction through the same kernel.
* select = the DIA path's sortable-bit top-k bisection
  (``par_ilut_dia._topk_mask``); filter = a mask update.

With the universe fixed, every outer iteration has identical shapes, so
the whole generate — candidates, select, filter, sweeps, ``iterations``
times — is a loop of tensor operations on the generate's device with no
host round-trip; the host only runs the symbolic closure/pair planning
before and the masked compaction after.  On CUDA the contractions run on
kernel D (``csrc/pair_contract.cu``).  Fill falling outside the
level-``level`` universe is dropped (it is the furthest-from-pattern,
smallest-magnitude fill) — the same bounded-universe trade the DIA path
makes.

ParICT is the symmetric analog on the lower universe only:
``tril(L L^H)`` pairs (``gt_ict_pairs_rowmajor``, ``k < j``) and the
IC update ``l_jj = sqrt(s_jj)``, ``l_ij = s_ij / l_jj``.

Falls back (returns None) when the closure or pair list exceeds the
budgets; ``ParIlut(algorithm=...)``/``ParIct(algorithm=...)`` route.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import pair_contract
from ..ops.registry import current_tier, lookup
from ..utils import stagetimer
from ..utils.plancache import SingleSlotCache, pattern_digest
from .par_ilut_dia import _compact_device, _topk_mask


# ---------------------------------------------------------------------------
# host symbolics
# ---------------------------------------------------------------------------

def _closure(d, level, max_slots, lower_only=False, enough=None):
    """Row-major (rows, cols) of the bounded ILU(level) fill universe
    (diagonal always included), or None when even level 1 exceeds
    ``max_slots``.  ``lower_only`` returns tril(universe) of the
    symmetric closure (pattern ∪ tril(L Lᵀ)) for ParICT.  ``enough``
    stops the level expansion early once the universe holds that many
    slots — the select step keeps only ``fill_in_limit * nnz`` entries,
    so a universe a few times that size already gives the pattern room
    to evolve, and deeper levels only inflate the pair lists (host
    planning cost grows with them; a level-3 universe at n=262k is
    ~100M slots against a ~6M keep budget)."""
    import scipy.sparse as sp
    n = d.shape[0]
    P = sp.csr_matrix(
        (np.ones(d.nnz, np.float32),
         (d.row_idx.astype(np.int64), d.col_idx.astype(np.int64))),
        shape=(n, n))
    P = (P + sp.identity(n, np.float32, format="csr")).tocsr()
    P.data.fill(1.0)
    if lower_only:
        P = sp.tril(P, 0, format="csr")
    for lvl in range(level):
        if enough is not None and P.nnz >= enough:
            break
        # sampled pre-estimate of the expansion size: the scipy product
        # itself costs minutes on wide random patterns — decline BEFORE
        # paying it.  Two gates: the hard slot cap, and (with a fill
        # budget) a 4x-budget proportionality cap — the select step keeps
        # only ~enough/2 entries, so a universe many times that size burns
        # quadratic pair-list cost on slots the filter will discard.
        est = _estimate_closure_nnz(P, lower_only)
        # 1.3x slack on the hard cap (sampling error ~15%): borderline
        # patterns pay one product and hit the EXACT nnz check below
        # instead of being declined on an over-estimate
        if est > 1.3 * max_slots or (enough is not None
                                     and est > 4 * enough):
            return None if lvl == 0 else _csr_pattern(P)
        if lower_only:
            F = sp.tril(P @ P.T, 0, format="csr")
        else:
            L = sp.tril(P, -1, format="csr")
            U = sp.triu(P, 0, format="csr")
            F = L @ U
        nxt = (P + F).tocsr()
        nxt.data.fill(1.0)
        if nxt.nnz == P.nnz:
            break
        if nxt.nnz > max_slots:
            return None if lvl == 0 else _csr_pattern(P)
        P = nxt
    return _csr_pattern(P)


def _estimate_closure_nnz(P, lower_only, sample=512, seed=0):
    """Sampled estimate of nnz(P ∪ fill) after one closure round —
    O(sample x row-density^2 log) vs the full SpGEMM's minutes on wide
    random patterns.  ILUT (``pattern ∪ pattern(L@U)``): per sampled
    row i, the union of U-rows of its L-columns.  ParICT
    (``tril(P P^T)``, P lower): row i unions the COLUMNS of its own
    column set, truncated to j <= i."""
    n = P.shape[0]
    ptr, cols = P.indptr, P.indices
    if lower_only:
        Pc = P.tocsc()
        cptr, crow = Pc.indptr, Pc.indices
    rng = np.random.default_rng(seed)
    ridx = np.sort(rng.choice(n, size=min(sample, n), replace=False))
    total = 0
    for i in ridx:
        ci = cols[ptr[i]:ptr[i + 1]]
        parts = [ci]
        if lower_only:
            for k in ci:
                rk = crow[cptr[k]:cptr[k + 1]]
                parts.append(rk[rk <= i])
        else:
            for k in ci[ci < i]:
                ck = cols[ptr[k]:ptr[k + 1]]
                parts.append(ck[ck >= k])
        total += np.unique(np.concatenate(parts)).size
    return int(total * (n / len(ridx)))


def _csr_pattern(P):
    P.sort_indices()
    rows = np.repeat(np.arange(P.shape[0], dtype=np.int64),
                     np.diff(P.indptr))
    return rows, P.indices.astype(np.int64)


def _plan_contract(pl_, pu_, po_, n_out, n_a, n_b, want_kernel):
    """Pair plan wrapper: packed kernel plan when the cuda tier will
    consume it, plus the raw triple for the reference tier/tail."""
    plan = None
    if want_kernel:
        plan = pair_contract.plan_pair_contract(pl_, pu_, po_, n_out, n_a,
                                                n_b)
    return dict(kernel=plan,
                raw=(np.asarray(pl_, np.int32), np.asarray(pu_, np.int32),
                     np.asarray(po_, np.int32)),
                n_out=int(n_out))


def _want_kernel(device):
    """True when the generate's contractions will run on the kernels: its
    device is CUDA and no ``use_tier("reference")`` is active."""
    return current_tier(device) == "cuda"


# ---------------------------------------------------------------------------
# symbolic-plan reuse (the reference's spgemm_reuse story,
# core/matrix/csr.cpp:50-51: symbolic structures captured once, numeric
# passes reuse them).  Packed plans cost up to a minute of closure + pair
# emission + planning at n=262k and depend only on the PATTERN, so the
# time-dependent-coefficients workflow (same pattern, new values each
# step) keeps a single most-recent plan per kind keyed on a pattern
# digest; a second generate() goes straight to the device loop.  Single
# slot: a plan's packed streams reach GBs at n=262k level-3 universes.
# ---------------------------------------------------------------------------

_PLAN_CACHE = SingleSlotCache()     # key: (kind, want_kernel)


def _cached_plan(d, kind, level, fill_in_limit, planner, device="cpu",
                 **kw):
    enough = (None if fill_in_limit is None
              else int(2 * fill_in_limit * d.nnz) + d.shape[0])
    dig = pattern_digest(d.row_idx, d.col_idx,
                         ints=(d.shape[0], d.shape[1], d.nnz, level,
                               -1 if enough is None else enough),
                         strs=(kind,))
    # the plan CONTENT is tier-dependent (kernel streams vs raw
    # triples, and kernel-budget rejects only apply on the cuda tier) —
    # key the slot on the tier so a reference-tier plan is never served
    # to a cuda-tier generate or vice versa
    key = (kind, _want_kernel(device))
    hit = _PLAN_CACHE.get(key, dig)
    if hit is not _PLAN_CACHE.MISS:
        return hit              # may be None: cached reject
    return _PLAN_CACHE.put(
        key, dig, planner(d, level=level, fill_in_limit=fill_in_limit,
                          device=device, **kw))


# universes below this skip the sampled pre-estimate (emission is cheap)
_EST_GATE_SLOTS = 4_000_000


def _estimate_ilut_pairs(n, rows, cols, sample=1024, seed=0):
    """O(sample x row-density) estimate of the ILUT pair-list length
    over the (row-major sorted) universe: pairs for output row i are
    sum_{k in Lrow(i)} |Urow(k) ∩ univrow(i)|.  Used to decline the
    device path in well under a second instead of after the full
    O(pairs) emission."""
    ptr = np.zeros(n + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    np.cumsum(ptr, out=ptr)
    rng = np.random.default_rng(seed)
    ridx = np.sort(rng.choice(n, size=min(sample, n), replace=False))
    total = 0
    for i in ridx:
        ci = cols[ptr[i]:ptr[i + 1]]
        for k in ci[ci < i]:
            ck = cols[ptr[k]:ptr[k + 1]]
            # U-row(k) = cols >= k of universe row k
            total += np.intersect1d(ci, ck[ck >= k],
                                    assume_unique=True).size
    return int(total * (n / len(ridx)))


def plan_packed_ilut(d, *, level=2, max_slots=40_000_000,
                     max_pairs=600_000_000, fill_in_limit=None,
                     device="cpu"):
    """Host-side symbolic plan for the packed device ParILUT, or None
    when the matrix/closure doesn't fit the budgets.  ``d`` must be
    canonical MatrixData; ``device`` is where the generate runs (a CUDA
    device plans the kernel streams)."""
    n, m = d.shape
    if n != m or d.nnz == 0 or n < 2:
        return None
    from .. import native
    enough = (None if fill_in_limit is None
              else int(2 * fill_in_limit * d.nnz) + d.shape[0])
    univ = _closure(d, level, max_slots, enough=enough)
    if univ is None:
        return None
    rows, cols = univ
    # fast decline: sampled pair-count estimate before the full O(pairs)
    # emission+planning (1.3x slack: the estimate's sampling error)
    if len(rows) > _EST_GATE_SLOTS and \
            _estimate_ilut_pairs(n, rows, cols) > 1.3 * max_pairs:
        return None
    low = rows > cols
    lr, lc = rows[low], cols[low]
    ur, uc = rows[~low], cols[~low]
    pairs = native.ilut_pairs_rowmajor_native(n, lr, lc, ur, uc,
                                              cap=max_pairs)
    if pairs is None:
        return None
    nl, nu = len(lr), len(ur)
    want = _want_kernel(device)
    prod = _plan_contract(*pairs, n_out=nl + nu, n_a=nl, n_b=nu,
                          want_kernel=want)
    if want and prod["kernel"] is None:
        return None
    ud = ur == uc
    diag_slots = np.flatnonzero(ud).astype(np.int64)
    diag_pos = np.zeros(n, np.int64)
    diag_pos[ur[ud]] = diag_slots
    dsrc = diag_pos[lc]
    den = _plan_contract(dsrc, dsrc, np.arange(nl, dtype=np.int64),
                         n_out=nl, n_a=nu, n_b=nu, want_kernel=want)
    if want and den["kernel"] is None:
        return None
    # A's values/pattern scattered onto the universe slots
    akey = d.row_idx.astype(np.int64) * n + d.col_idx
    lpos = np.minimum(np.searchsorted(akey, lr * n + lc), akey.size - 1)
    lhit = akey[lpos] == lr * n + lc
    upos = np.minimum(np.searchsorted(akey, ur * n + uc), akey.size - 1)
    uhit = akey[upos] == ur * n + uc
    return dict(n=n, nl=nl, nu=nu, lr=lr, lc=lc, ur=ur, uc=uc,
                prod=prod, den=den, diag_slots=diag_slots,
                al_src=(lpos, lhit), au_src=(upos, uhit))


def plan_packed_ict(d, *, level=2, max_slots=40_000_000,
                    max_pairs=600_000_000, fill_in_limit=None,
                    device="cpu"):
    """Host-side plan for the packed device ParICT (lower universe)."""
    n, m = d.shape
    if n != m or d.nnz == 0 or n < 2:
        return None
    from .. import native
    enough = (None if fill_in_limit is None
              else int(2 * fill_in_limit * d.nnz) + d.shape[0])
    univ = _closure(d, level, max_slots, lower_only=True, enough=enough)
    if univ is None:
        return None
    lr, lc = univ
    nl = len(lr)
    pairs = native.ict_pairs_rowmajor_native(n, lr, lc, cap=max_pairs)
    if pairs is None:
        return None
    want = _want_kernel(device)
    prod = _plan_contract(*pairs, n_out=nl, n_a=nl, n_b=nl,
                          want_kernel=want)
    if want and prod["kernel"] is None:
        return None
    isd = lr == lc
    diag_slots = np.flatnonzero(isd).astype(np.int64)
    diag_pos = np.zeros(n, np.int64)
    diag_pos[lr[isd]] = diag_slots
    dsrc = diag_pos[lc]
    den = _plan_contract(dsrc, dsrc, np.arange(nl, dtype=np.int64),
                         n_out=nl, n_a=nl, n_b=nl, want_kernel=want)
    if want and den["kernel"] is None:
        return None
    akey = d.row_idx.astype(np.int64) * n + d.col_idx
    lpos = np.minimum(np.searchsorted(akey, lr * n + lc), akey.size - 1)
    lhit = akey[lpos] == lr * n + lc
    return dict(n=n, nl=nl, lr=lr, lc=lc, prod=prod, den=den,
                diag_slots=diag_slots, al_src=(lpos, lhit))


# ---------------------------------------------------------------------------
# device plumbing
# ---------------------------------------------------------------------------

def _put(x, device):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _ship_contract(cplan, device):
    """(arrs dict, static meta) of one pair-contraction plan on
    ``device``.  The shipped tensors are memoized on the plan dict (for
    one device at a time, and on the CPU one scatter mode): a cached plan
    (same-pattern regenerate) keeps its streams device-resident, so the
    second generate transfers only the matrix values.  On a CUDA device a
    kernel plan's slabs (``pls``, ``pus``, ``pos`` and the tables) are
    repacked once into the pad-free pair stream that both kernels read
    (``pair_contract.pair_stream``) and dropped, whatever the mode; on the
    CPU the plain version reads the slabs of the active ``_DOT_MODE``
    (``pes``/``pesp`` for kernel D, ``pos`` for kernel E)."""
    mode = pair_contract._DOT_MODE
    on_card = torch.device(device).type == "cuda"
    key = (str(device), None if on_card else mode)
    shipped = cplan.get("_shipped")
    if shipped is not None and shipped[0] == key:
        return shipped[1]
    cplan.pop("_shipped", None)        # free the other device's copy first
    k = cplan["kernel"]
    if k is not None:
        streams = (("pos",) if on_card or mode == "onehot"
                   else ("pes", "pesp"))
        arrs = {n: _put(k[n], device) for n in
                ("pls", "pus", *streams, "lq", "uq", "nv", "lbase",
                 "ubase")}
        arrs["tail"] = tuple(_put(t, device).long() for t in k["tail"])
        if on_card:
            arrs = {"stream": pair_contract.pair_stream(arrs, k["meta"])}
        out = arrs, ("kernel", k["meta"])
    else:
        rl, ru, ro = cplan["raw"]
        out = ({"raw": tuple(_put(t, device).long() for t in (rl, ru, ro))},
               ("raw", cplan["n_out"]))
    cplan["_shipped"] = (key, out)
    return out


def _contract(a, b, arrs, cmeta):
    """Registry-dispatched pair contraction."""
    kind, info = cmeta
    if kind == "raw":
        rl, ru, ro = arrs["raw"]
        return lookup("pair_contract", a.device)(a, b, rl, ru, ro, info)
    return lookup("pair_contract_planned", a.device)(a, b, arrs, info)


# ---------------------------------------------------------------------------
# ParILUT device loop
# ---------------------------------------------------------------------------

def _run_packed(arrs, Al, Au, Aml, Amu, meta, iterations, sweeps,
                keep_l, keep_u):
    """The whole ParILUT loop on the device of ``Al``: scaled init + 3
    init sweeps + ``iterations`` x (candidates -> select -> filter ->
    sweeps).  Returns (Vl, Vu, Ml, Mu)."""
    nl, nu, prod_meta, den_meta = meta
    dt = Al.dtype
    one = torch.ones((), dtype=dt, device=Al.device)
    zero = torch.zeros((), dtype=dt, device=Al.device)
    dslots = arrs["diag_slots"]

    def rden(Vu, Muf):
        den = _contract(Vu, Muf, arrs["den"], den_meta)
        return torch.where(den == 0, one,
                           one / torch.where(den == 0, one, den))

    def fixed_point(Vl, Vu, Muf):
        c = _contract(Vl, Vu, arrs["prod"], prod_meta)
        r = rden(Vu, Muf)
        return (Al - c[:nl]) * r, Au - c[nl:]

    def sweep_block(Vl, Vu, Ml, Mu, count):
        Muf = Mu.to(dt)
        for _ in range(count):
            nl_, nu_ = fixed_point(Vl, Vu, Muf)
            Vl = torch.where(Ml.bool(), nl_, zero)
            Vu = torch.where(Mu.bool(), nu_, zero)
        return Vl, Vu

    def iteration(Vl, Vu, Ml, Mu):
        # 1+2. candidates (the pair product on the masks) + Jacobi seed
        cm = _contract(Ml.to(dt), Mu.to(dt), arrs["prod"], prod_meta)
        cand_l = Aml | Ml | (torch.real(cm[:nl]) > 0.5).to(torch.uint8)
        cand_u = Amu | Mu | (torch.real(cm[nl:]) > 0.5).to(torch.uint8)
        nl_, nu_ = fixed_point(Vl, Vu, Mu.to(dt))
        V2l = torch.where(cand_l.bool(), nl_, zero)
        V2u = torch.where(cand_u.bool(), nu_, zero)
        # 3+4. select + filter: top-k magnitude per factor (diag pinned)
        mag_u = V2u.abs()
        mag_u[dslots] = float("inf")
        M3l = _topk_mask(V2l.abs(), cand_l, keep_l)
        M3u = _topk_mask(mag_u, cand_u, keep_u)
        M3u[dslots] = 1
        # 5. sweeps on the filtered pattern
        V3l, V3u = sweep_block(V2l * M3l, V2u * M3u, M3l, M3u, sweeps)
        return V3l, V3u, M3l, M3u

    Ml0 = Aml
    Mu0 = Amu.clone()
    Mu0[dslots] = 1
    r0 = rden(Au * Amu, Mu0.to(dt))
    Vl0 = Al * r0 * Ml0
    Vu0 = Au * Mu0
    Vl0, Vu0 = sweep_block(Vl0, Vu0, Ml0, Mu0, 3)
    carry = (Vl0, Vu0, Ml0, Mu0)
    for _ in range(iterations):
        carry = iteration(*carry)
    return carry


def generate_packed(d, iterations, fill_in_limit, sweeps, *, level=3,
                    plan=None, device="cpu"):
    """Run the device-resident packed ParILUT on ``device``; returns
    (lr, lc, lv, ur, uc, uv) split host arrays (L strictly lower) or None
    when the pattern/budgets reject."""
    device = torch.device(device)
    if plan is None:
        plan = _cached_plan(d, "ilut", level, fill_in_limit,
                            plan_packed_ilut, device=device)
    if plan is None:
        return None
    cdtype = d.values.dtype
    n, nl, nu = plan["n"], plan["nl"], plan["nu"]
    lpos, lhit = plan["al_src"]
    upos, uhit = plan["au_src"]
    vals = d.values.astype(cdtype)
    Al = np.where(lhit, vals[lpos], 0)
    Au = np.where(uhit, vals[upos], 0)
    Aml = (lhit & (Al != 0)).astype(np.uint8)
    Amu = (uhit & (Au != 0)).astype(np.uint8)
    keep_l = int(np.ceil(fill_in_limit * max(int(Aml.sum()), 1)))
    nnz_u0 = int(Amu.sum()) + n - int(Amu[plan["diag_slots"]].sum())
    keep_u = int(np.ceil(fill_in_limit * max(nnz_u0, 1)))

    with stagetimer.stage("transfer"):
        prod_arrs, prod_meta = _ship_contract(plan["prod"], device)
        den_arrs, den_meta = _ship_contract(plan["den"], device)
        arrs = dict(prod=prod_arrs, den=den_arrs,
                    diag_slots=_put(plan["diag_slots"], device))
        Ald = _put(Al, device)
        Aud = _put(Au, device)
        Amld = _put(Aml, device)
        Amud = _put(Amu, device)
        stagetimer.sync((arrs, Ald, Aud, Amld, Amud))
    meta = (nl, nu, prod_meta, den_meta)
    kml = max(keep_l, int(Aml.sum()))
    kmu = max(keep_u + n, nnz_u0)
    with stagetimer.stage("device"):
        Vl, Vu, Ml, Mu = _run_packed(
            arrs, Ald, Aud, Amld, Amud, meta, int(iterations),
            int(sweeps), keep_l, keep_u)
        lv_d, lslot, lcount = _compact_device(Vl, Ml, kml)
        uv_d, uslot, ucount = _compact_device(Vu, Mu, kmu)
        stagetimer.sync((lv_d, lslot, lcount, uv_d, uslot, ucount))
    with stagetimer.stage("transfer"):
        nkl, nku = int(lcount), int(ucount)
        lsl = lslot.cpu().numpy()[:nkl]
        usl = uslot.cpu().numpy()[:nku]
        lv = lv_d.cpu().numpy()[:nkl]
        uv = uv_d.cpu().numpy()[:nku]
    return (plan["lr"][lsl], plan["lc"][lsl], lv,
            plan["ur"][usl], plan["uc"][usl], uv)


# ---------------------------------------------------------------------------
# ParICT device loop
# ---------------------------------------------------------------------------

def _run_packed_ict(arrs, Al, Aml, meta, iterations, sweeps, keep_n):
    nl, prod_meta, den_meta = meta
    dt = Al.dtype
    dev = Al.device
    rdt = torch.real(Al).dtype
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    tiny = torch.tensor(torch.finfo(rdt).tiny, dtype=rdt, device=dev)
    dslots = arrs["diag_slots"]
    isd = torch.zeros(nl, dtype=torch.bool, device=dev)
    isd[dslots] = True

    def conj(x):
        return torch.conj(x).resolve_conj()

    def ic_step(Vl, Muf):
        """One IC fixed-point evaluation: diag from s, then offdiag with
        the NEW diag (the reference sweep's two-stage update)."""
        c = _contract(Vl, conj(Vl), arrs["prod"], prod_meta)
        s = Al - c
        dn = torch.sqrt(torch.maximum(torch.abs(torch.real(s[dslots])),
                                      tiny))
        Vtmp = s.clone()
        Vtmp[dslots] = dn.to(dt)
        den = _contract(Vtmp, Muf, arrs["den"], den_meta)
        den = torch.where(den == 0, one, den)
        return torch.where(isd, Vtmp, s / conj(den))

    def sweep_block(Vl, Ml, count):
        Muf = Ml.to(dt)
        for _ in range(count):
            Vl = torch.where(Ml.bool(), ic_step(Vl, Muf), zero)
        return Vl

    def iteration(Vl, Ml):
        cm = _contract(Ml.to(dt), Ml.to(dt), arrs["prod"], prod_meta)
        cand = Aml | Ml | (torch.real(cm) > 0.5).to(torch.uint8)
        cand[dslots] = 1
        V2 = torch.where(cand.bool(), ic_step(Vl, cand.to(dt)), zero)
        mag = V2.abs()
        mag[dslots] = float("inf")
        M3 = _topk_mask(mag, cand, keep_n)
        M3[dslots] = 1
        V3 = sweep_block(V2 * M3, M3, sweeps)
        return V3, M3

    M0 = Aml.clone()
    M0[dslots] = 1
    d0 = torch.sqrt(torch.abs(Al[dslots]))
    d0 = torch.where(d0 == 0, torch.ones((), dtype=rdt, device=dev),
                     d0).to(dt)
    Ad = Al.clone()
    Ad[dslots] = d0
    den0 = _contract(Ad, M0.to(dt), arrs["den"], den_meta)
    den0 = torch.where(den0 == 0, one, den0)
    V0 = torch.where(isd, Ad, Al / conj(den0)) * M0
    V0 = sweep_block(V0, M0, 3)
    carry = (V0, M0)
    for _ in range(iterations):
        carry = iteration(*carry)
    return carry


def generate_packed_ict(d, iterations, fill_in_limit, sweeps=2, *,
                        level=3, plan=None, device="cpu"):
    """Run the device-resident packed ParICT on ``device``; returns
    (lr, lc, lv) of the lower factor (diagonal included) or None."""
    device = torch.device(device)
    if plan is None:
        plan = _cached_plan(d, "ict", level, fill_in_limit,
                            plan_packed_ict, device=device)
    if plan is None:
        return None
    cdtype = d.values.dtype
    n, nl = plan["n"], plan["nl"]
    lpos, lhit = plan["al_src"]
    vals = d.values.astype(cdtype)
    Al = np.where(lhit, vals[lpos], 0)
    Aml = (lhit & (Al != 0)).astype(np.uint8)
    nnz0 = int(Aml.sum()) + n - int(Aml[plan["diag_slots"]].sum())
    keep_n = int(np.ceil(fill_in_limit * max(nnz0, 1)))

    with stagetimer.stage("transfer"):
        prod_arrs, prod_meta = _ship_contract(plan["prod"], device)
        den_arrs, den_meta = _ship_contract(plan["den"], device)
        arrs = dict(prod=prod_arrs, den=den_arrs,
                    diag_slots=_put(plan["diag_slots"], device))
        Ald = _put(Al, device)
        Amld = _put(Aml, device)
        stagetimer.sync((arrs, Ald, Amld))
    meta = (nl, prod_meta, den_meta)
    kml = max(keep_n + n, nnz0)
    with stagetimer.stage("device"):
        Vl, Ml = _run_packed_ict(arrs, Ald, Amld, meta,
                                 int(iterations), int(sweeps), keep_n)
        lv_d, lslot, lcount = stagetimer.sync(
            _compact_device(Vl, Ml, kml))
    with stagetimer.stage("transfer"):
        nkl = int(lcount)
        lsl = lslot.cpu().numpy()[:nkl]
        lv = lv_d.cpu().numpy()[:nkl]
    return plan["lr"][lsl], plan["lc"][lsl], lv
