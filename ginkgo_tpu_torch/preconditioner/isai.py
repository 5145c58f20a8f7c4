"""ISAI — incomplete sparse approximate inverse preconditioner
(``ginkgo_tpu/preconditioner/isai.py`` in torch).

Analog of ``include/ginkgo/core/preconditioner/isai.hpp:78-95`` /
``core/preconditioner/isai.cpp:123-220``: the approximate inverse M
carries the sparsity pattern of A^``sparsity_power``; each row m_i solves
the small dense system  A(J_i, J_i)ᵀ m = e_i  restricted to its pattern
J_i.

All rows are padded to the max pattern size S and the n small systems
become ONE (n, S, S) batched solve (``ops/gauss_jordan.batched_solve``) on
A's device — Ginkgo's per-row subwarp kernels and its "excess system"
fallback collapse into a single batched solve (pad rows are
identity-filled).  The blocks are filled by one of three routes, chosen
from the pattern and the device before any work starts:

* the DIA fill (``_isai_fill_dia``), for diagonal-structured A and
  pattern (<= 64 offsets each), on any device: S² shifted row gathers of
  the zero-padded DIA slab;
* the packed fill (``_isai_packed_kernel``), on a CUDA device at
  n >= 16,384 within the slab budget (``_want_packed_fill``): one scatter
  of cached pattern pairs into an identity slab;
* the host fill otherwise: the native ``gt_isai_fill`` (numpy without the
  native library), then the batched solve on the device.

The inverse comes back as a ``Csr`` (``automatical`` strategy) on A's
device.  Under ``utils.stagetimer.collect`` each route reports its
``transfer`` and ``device`` seconds; the rest of a generate is host work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.linop import LinOp
from ..base.matrix_data import MatrixData
from ..device import matrix_data_and_device
from ..factorization.par_ilu import Ic0
from ..factorization.par_ilut_dia import _dia_slab_device, _shifted_rows
from ..matrix.csr import Csr
from ..native import isai_fill_native, isai_pairs_native
from ..ops.gauss_jordan import batched_solve
from ..ops.spgemm import spgemm_data
from ..utils import stagetimer
from ..utils.plancache import SingleSlotCache, pattern_digest


def _power_pattern(d: MatrixData, power: int, device) -> MatrixData:
    pat = MatrixData(d.shape, d.row_idx, d.col_idx,
                     np.ones_like(d.values))
    out = pat
    for _ in range(power - 1):
        out = spgemm_data(out, pat, device=device)
        out.values[:] = 1.0
    return out.canonical()


def _restrict_triangular(p: MatrixData, mode: str) -> MatrixData:
    if mode == "lower":
        keep = p.row_idx >= p.col_idx
    elif mode == "upper":
        keep = p.row_idx <= p.col_idx
    else:
        return p
    return MatrixData(p.shape, p.row_idx[keep], p.col_idx[keep],
                      p.values[keep])


def _isai_subs(slab, vm, qmap, ob, pad, diag_slot):
    """(n, S, S) ISAI blocks and (n, S) right-hand sides from the DIA
    slab: S² shifted row gathers, subs[i, a, b] = slabz[qmap[a, b],
    i + ob[b]] (0 outside [0, n)).  vm (n, S) is the pattern-slot
    validity mask (pattern entries can be missing at stencil boundaries —
    'holes' in a diagonal); invalid slots get zeroed rows/columns and an
    identity pin so the batched solve stays nonsingular and returns 0
    there."""
    n = slab.shape[1]
    S = ob.shape[0]
    slabz = torch.cat([slab, slab.new_zeros(1, n)])
    # one (row, shift) pair per (b, a): b-major, as the reference's vmap
    offs = torch.stack([qmap.T.reshape(-1),
                        ob[:, None].expand(S, S).reshape(-1)], dim=1)
    subs = _shifted_rows(slabz, offs, pad).reshape(S, S, n).permute(2, 1, 0)
    vmv = vm.to(slab.dtype)
    subs = subs * (vmv[:, :, None] * vmv[:, None, :])
    subs = subs + (torch.eye(S, dtype=slab.dtype, device=slab.device)[None]
                   * (1 - vmv)[:, :, None])
    rhs = slab.new_zeros(n, S)
    rhs[:, diag_slot] = 1
    return subs, rhs


def _isai_fill_dia(d, prow, pcol, device):
    """Device-resident block fill for diagonal-structured matrices.

    When A and the ISAI pattern are both diagonal-structured (<= 64
    distinct diagonal offsets; boundary holes in a diagonal are fine —
    they come back as a validity mask), every row's block is the same
    offset-indexed gather
    ``subs[i, a, b] = A[i+o_b, i+o_a] = slab[q(o_a - o_b), i + o_b]``
    — S² row gathers + shifts from the zero-padded DIA slab, no host
    (n, S, S) materialization and no 8-bytes-per-slot transfer (the
    reference fills these blocks on device too,
    common/cuda_hip/preconditioner/isai_kernels.cpp:160-210).

    Returns (subs, rhs, offs_pat) on ``device``; the caller has checked
    ``_dia_fits``."""
    n = d.shape[0]
    nnzp = prow.shape[0]
    poff = pcol - prow
    offs_pat = np.unique(poff)
    offsA = np.unique(d.col_idx.astype(np.int64) - d.row_idx)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    p = np.searchsorted(offsA, d.col_idx.astype(np.int64)
                        - d.row_idx).astype(np.int32)
    slab = _dia_slab_device(dev(d.values), dev(p),
                            dev(d.row_idx.astype(np.int32)), offsA.size, n)
    S = offs_pat.size
    # pattern validity mask (n, S): pattern diagonals have holes at
    # stencil boundaries, so slot validity comes from the pattern
    # itself, not a range check
    p_pat = np.searchsorted(offs_pat, poff).astype(np.int32)
    vm = _dia_slab_device(torch.ones(nnzp, dtype=torch.float32,
                                     device=device),
                          dev(p_pat), dev(prow.astype(np.int32)), S, n).T
    diff = offs_pat[:, None] - offs_pat[None, :]       # (a, b)
    q = np.searchsorted(offsA, diff)
    qc = np.minimum(q, offsA.size - 1)
    qmap = np.where(offsA[qc] == diff, qc, offsA.size)  # -> zero row
    pad = int(max(int(np.abs(offs_pat).max()), 1))
    subs, rhs = _isai_subs(slab, vm, dev(qmap.astype(np.int64)),
                           dev(offs_pat.astype(np.int64)), pad,
                           int(np.searchsorted(offs_pat, 0)))
    return subs, rhs, offs_pat


def _isai_packed_kernel(avals, dest, loc, hit, dslot, n, S):
    """Device-resident unstructured block fill + batched solve: an
    identity-initialized (n, S, S) slab takes ONE scatter of the live
    pairs (subs[i, a, b] = A[J_i[b], J_i[a]]; pair positions are
    pattern-only host symbolics, cached across generates), then the
    batched solve.  The reference fills and solves these blocks on
    device for any pattern
    (common/cuda_hip/preconditioner/isai_kernels.cpp)."""
    subs = torch.eye(S, dtype=avals.dtype, device=avals.device).repeat(
        n, 1, 1)
    vals = torch.where(hit, avals[loc], torch.zeros((), dtype=avals.dtype,
                                                    device=avals.device))
    # identity-initialized slab: A hits overwrite their (a, b) slots;
    # kept non-hit pairs are exactly the valid diagonal slots whose
    # submatrix diagonal is structurally zero (clear the stale 1)
    subs.view(-1)[dest] = vals
    rhs = avals.new_zeros(n, S)
    rhs[torch.arange(n, device=avals.device), dslot] = 1
    return batched_solve(subs, rhs)


_ISAI_SYM_CACHE = SingleSlotCache()     # key: mode


def _want_packed_fill(n, S, itemsize, device):
    """Route to the device-resident unstructured fill: a CUDA device,
    above the launch-amortization size, slab within the card's memory
    budget (tests monkeypatch this to force/disable the path)."""
    return (device.type == "cuda" and n >= 16384
            and n * S * S * itemsize <= (3 << 30)
            and n * S * S < (1 << 31))


def _isai_packed_symbolics(d, ptr, lens, S, prow, pcol):
    """Pattern-only pair symbolics for the device fill (host, cached):
    for entry e = slot a of row i and every slot b of the same row,
    dest = flat (i, a, b) and loc/hit = A's lookup of (J_i[b], J_i[a]).
    Ships LIVE pairs only: the device slab is identity-initialized; A
    hits overwrite, and valid DIAGONAL slots without an A hit write an
    explicit 0 (the dense fill leaves 0 there; identity would leave a
    stale 1) — non-hit off-diagonal slots are already 0.  Primary path
    is the native two-pointer merge (gt_isai_pairs, O(Σ_b (m + deg));
    the numpy fallback materializes the Σ m² pair list)."""
    n = d.shape[0]
    nnzp = prow.shape[0]
    a_slot = np.arange(nnzp) - ptr[prow]
    nat = isai_pairs_native(S, d.row_ptrs(),
                            np.ascontiguousarray(d.col_idx, np.int64),
                            ptr, np.ascontiguousarray(pcol, np.int64))
    if nat is not None:
        dest, loc, hit = nat
    else:
        cnt = lens[prow]
        pair_a = np.repeat(np.arange(nnzp), cnt)
        total = int(cnt.sum())
        b_local = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        row_of = prow[pair_a]
        ja = pcol[pair_a]
        jb = pcol[ptr[row_of] + b_local]
        akeys = d.row_idx.astype(np.int64) * n + d.col_idx
        qkeys = jb * n + ja
        loc = np.minimum(np.searchsorted(akeys, qkeys), d.nnz - 1)
        hit = akeys[loc] == qkeys
        dest = (row_of * S + a_slot[pair_a]) * S + b_local
        diag_miss = (a_slot[pair_a] == b_local) & ~hit
        keep = hit | diag_miss
        dest, loc, hit = dest[keep], loc[keep], hit[keep]
    # per-row rhs position of the pattern's diagonal entry
    on_diag = pcol == prow
    dslot = np.zeros(n, np.int64)
    dslot[prow[on_diag]] = a_slot[on_diag]
    return dict(dest=dest, loc=loc, hit=hit,
                dslot=dslot, a_slot=a_slot, nnzp=nnzp)


def _host_fill(d, ptr, lens, S, prow, pcol, nnzp):
    """(subs, rhs, a_slot) on the host: the native ``gt_isai_fill`` (a
    two-pointer merge of each pattern row against A's rows,
    O(Σ_b (m + deg(J_b)))), or without the native library a numpy pair
    list (every entry e (slot a of row i) against every slot b of the
    same row, Σ mᵢ² pairs via group repeat/arange) looked up in A by
    sorted (row, col) key."""
    n = d.shape[0]
    dtype = d.values.dtype
    a_slot = np.arange(nnzp) - ptr[prow]           # position within row
    wide = np.complex128 if np.iscomplexobj(d.values) else np.float64
    if d.nnz:
        # identity base guards singular padding; the kernel clears and
        # fills each live (m, m) region in place.  zeros + one strided
        # diagonal write beats np.tile's full (n, S, S) broadcast copy.
        subs_w = np.zeros((n, S, S), wide)
        subs_w[:, np.arange(S), np.arange(S)] = 1.0
        rhs_w = np.zeros((n, S), wide)
        if isai_fill_native(S, d.row_ptrs(),
                            np.ascontiguousarray(d.col_idx, np.int64),
                            np.array(d.values, wide, copy=True),
                            ptr, pcol, subs_w, rhs_w):
            return (subs_w.astype(dtype, copy=False),
                    rhs_w.astype(dtype, copy=False), a_slot)
    cnt = lens[prow]                           # pairs per entry
    pair_a = np.repeat(np.arange(nnzp), cnt)   # entry index for slot a
    total = int(cnt.sum())
    b_local = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    row_of = prow[pair_a]
    ja = pcol[pair_a]
    jb = pcol[ptr[row_of] + b_local]
    if d.nnz:
        akeys = d.row_idx.astype(np.int64) * n + d.col_idx
        qkeys = jb * n + ja
        loc = np.minimum(np.searchsorted(akeys, qkeys), d.nnz - 1)
        pair_vals = np.where(akeys[loc] == qkeys,
                             d.values[loc], 0.0).astype(dtype)
    else:
        pair_vals = np.zeros(total, dtype)
    subs = np.tile(np.eye(S, dtype=dtype), (n, 1, 1))
    subs[row_of, a_slot[pair_a], b_local] = pair_vals
    rhs = np.zeros((n, S), dtype)
    on_diag = pcol == prow
    rhs[prow[on_diag], a_slot[on_diag]] = 1.0
    return subs, rhs, a_slot


def _dia_fits(d, prow, pcol) -> bool:
    """A and the ISAI pattern are both diagonal-structured (<= 64
    distinct diagonal offsets each) and not empty."""
    return (d.nnz > 0 and prow.size > 0
            and np.unique(pcol - prow).size <= 64
            and np.unique(d.col_idx.astype(np.int64)
                          - d.row_idx).size <= 64)


def _fill_route(d, prow, pcol, S, device) -> str:
    if _dia_fits(d, prow, pcol):
        return "dia"
    if _want_packed_fill(d.shape[0], S, np.dtype(d.values.dtype).itemsize,
                         device):
        return "packed"
    return "host"


def isai_route(A, sparsity_power: int = 1, mode: str = "general") -> str:
    """The block fill ``generate_isai`` takes for A: "dia", "packed" or
    "host" (the same decision, taken on the pattern alone)."""
    data, device = matrix_data_and_device(A)
    d = data.canonical()
    prow, pcol, _, S = _isai_pattern(d, sparsity_power, mode, device)
    return _fill_route(d, prow, pcol, S, device)


def _isai_pattern(d, sparsity_power, mode, device):
    """(prow, pcol, ptr, S) of the ISAI pattern: A^power's pattern
    restricted by ``mode``, with every diagonal entry present."""
    n = d.shape[0]
    pattern = _restrict_triangular(
        _power_pattern(d, sparsity_power, device), mode)
    # ensure the diagonal is in every row's pattern (skip the re-sort
    # entirely when it already is — the power-1 case on PDE matrices)
    have = np.zeros(n, bool)
    have[pattern.row_idx[pattern.row_idx == pattern.col_idx]] = True
    if not have.all():
        diag = np.flatnonzero(~have).astype(np.int64)
        pattern = MatrixData(
            (n, n),
            np.concatenate([pattern.row_idx.astype(np.int64), diag]),
            np.concatenate([pattern.col_idx.astype(np.int64), diag]),
            np.ones(pattern.nnz + diag.size, d.values.dtype)).canonical()
    ptr = pattern.row_ptrs()                       # (n+1,)
    S = int(np.diff(ptr).max())
    return (pattern.row_idx.astype(np.int64),
            pattern.col_idx.astype(np.int64), ptr, S)


def generate_isai(A, sparsity_power: int = 1, mode: str = "general") -> Csr:
    """Build the approximate-inverse Csr for A (host symbolic + one
    batched solve on A's device; the CUDA device for plain MatrixData)."""
    data, device = matrix_data_and_device(A)
    d = data.canonical()
    n = d.shape[0]
    dtype = d.values.dtype
    prow, pcol, ptr, S = _isai_pattern(d, sparsity_power, mode, device)
    lens = np.diff(ptr)                            # (n,) >= 1 (diagonal)
    nnzp = prow.shape[0]

    def result(mvals):
        m_data = MatrixData((n, n), prow, pcol, mvals.astype(dtype))
        return Csr.from_data(m_data.canonical(), strategy="automatical",
                             device=device)

    route = _fill_route(d, prow, pcol, S, device)
    # diagonal-structured fast path: device-resident block fill from
    # the DIA slab (no host (n, S, S) materialization, no transfer)
    if route == "dia":
        with stagetimer.stage("device"):
            subs_d, rhs_d, offs_pat = _isai_fill_dia(d, prow, pcol, device)
            sols = batched_solve(subs_d, rhs_d)             # (n, S)
            slot = np.searchsorted(offs_pat, pcol - prow)
            sel = torch.from_numpy(prow * S + slot).to(device)
            mv = stagetimer.sync(sols.reshape(-1)[sel])
        with stagetimer.stage("transfer"):
            mvals = mv.cpu().numpy()
        return result(mvals)

    # unstructured device path: host pattern symbolics (cached on the
    # pattern+A-pattern digest; device index arrays cached too, so a
    # same-pattern regenerate ships only A's values) + one device
    # scatter into an identity slab + the batched solve.  Budget: the
    # (n, S, S) slab must fit comfortably in the card's memory.
    if route == "packed":
        dig = pattern_digest(prow, pcol, d.row_idx, d.col_idx,
                             ints=(n, S, nnzp, d.nnz), strs=(device,))
        sym = _ISAI_SYM_CACHE.get(mode, dig)
        if sym is _ISAI_SYM_CACHE.MISS:
            sym = _isai_packed_symbolics(d, ptr, lens, S, prow, pcol)
            # msel: per-pattern-entry flat (row, slot) position — the
            # result gather runs ON DEVICE so only nnzp values come
            # back over the host link, not the (n, S) slab
            sym["msel"] = prow * S + sym["a_slot"]
            with stagetimer.stage("transfer"):
                sym["dev"] = stagetimer.sync(tuple(
                    torch.from_numpy(np.ascontiguousarray(sym[k])).to(device)
                    for k in ("dest", "loc", "hit", "dslot", "msel")))
            _ISAI_SYM_CACHE.put(mode, dig, sym)
        with stagetimer.stage("transfer"):
            avals = stagetimer.sync(torch.from_numpy(d.values).to(device))
        with stagetimer.stage("device"):
            dest_d, loc_d, hit_d, dslot_d, msel_d = sym["dev"]
            sols = _isai_packed_kernel(avals, dest_d, loc_d, hit_d, dslot_d,
                                       n, S)
            mv = stagetimer.sync(sols.reshape(-1)[msel_d])
        with stagetimer.stage("transfer"):
            mvals = mv.cpu().numpy()
        return result(mvals)

    subs, rhs, a_slot = _host_fill(d, ptr, lens, S, prow, pcol, nnzp)
    with stagetimer.stage("transfer"):
        subs, rhs, sel = stagetimer.sync(tuple(
            torch.from_numpy(a).to(device)
            for a in (subs, rhs, prow * S + a_slot)))
    with stagetimer.stage("device"):
        mv = stagetimer.sync(batched_solve(subs, rhs).reshape(-1)[sel])
    with stagetimer.stage("transfer"):
        mvals = mv.cpu().numpy()
    return result(mvals)


class SpdIsai(LinOp):
    """spd variant: M = L⁻ᴴ_approx · L⁻¹_approx (isai.cpp spd path)."""

    def __init__(self, linv, linv_h):
        self.linv = linv
        self.linv_h = linv_h

    @property
    def shape(self):
        return self.linv.shape

    def _apply(self, b):
        return self.linv_h._apply(self.linv._apply(b))


class Isai:
    """Factory: ``Isai(mode='general'|'lower'|'upper'|'spd',
    sparsity_power=1).generate(A)``."""

    def __init__(self, mode: str = "general", sparsity_power: int = 1):
        if mode not in ("general", "lower", "upper", "spd"):
            raise ValueError(f"unknown ISAI mode {mode!r}")
        self.mode = mode
        self.sparsity_power = sparsity_power

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> LinOp:
        if self.mode == "spd":
            L = Ic0().generate(A).l_factor
            linv = generate_isai(L, self.sparsity_power, "lower")
            lt = linv.to_matrix_data().conj_transpose().sort_row_major()
            return SpdIsai(linv=linv,
                           linv_h=Csr.from_data(lt, strategy="automatical",
                                                device=linv.device))
        return generate_isai(A, self.sparsity_power, self.mode)
