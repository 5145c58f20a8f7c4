"""Double-word float32 ("df64") arithmetic (``ginkgo_tpu/ops/df64.py`` in
torch).

A value is an unevaluated sum ``hi + lo`` of two f32 with |lo| <=
ulp(hi)/2, giving ~48 effective mantissa bits (~1.8e-15 relative): the
standard double-double construction at float32 granularity, kept as the
reference computes it so that both give the same bits on f32 inputs (the
card's native f64 is not swapped in):

* error-free transforms: ``two_sum`` (Knuth), ``split``/``two_prod``
  (Dekker, no FMA: eager torch runs each multiply and add as its own
  rounded operation, and nothing here may be compiled, or ``a * b + c``
  could fuse and ``two_prod`` would stop being error-free)
* df64 add/mul/scale/div
* compensated reductions: ``df64_sum`` / ``df64_dot`` / ``df64_norm2``
  via elementwise error-free transforms + a log2-depth pairwise df64 tree
* df64 SpMV over the banded (DIA), packed-slot and COO layouts
* ``ir_df64``: iterative refinement with the residual evaluated in df64 —
  f32 inner solves converge to ~1e-12 residuals.

All functions take/return plain f32 tensors (hi, lo).  The distributed
dot (``df64_dot_dist``) joins with the distributed tier.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

_SPLIT = 4097.0          # 2^12 + 1 (f32 has 24 mantissa bits)


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth; no branch)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split: a = hi + lo with 12-bit halves."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b = p + e (Dekker; FMA-free)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(xh, xl, yh, yl):
    """df64 + df64 (Dekker add2, ~11 flops)."""
    sh, se = two_sum(xh, yh)
    te = xl + yl + se
    return quick_two_sum(sh, te)


def df_add_f32(xh, xl, y):
    sh, se = two_sum(xh, y)
    return quick_two_sum(sh, xl + se)


def df_neg(xh, xl):
    return -xh, -xl


def df_mul(xh, xl, yh, yl):
    """df64 * df64."""
    ph, pe = two_prod(xh, yh)
    pe = pe + xh * yl + xl * yh
    return quick_two_sum(ph, pe)


def df_mul_f32(xh, xl, y):
    ph, pe = two_prod(xh, y)
    return quick_two_sum(ph, pe + xl * y)


def df_div(xh, xl, yh, yl):
    """df64 / df64 (one Newton correction of the f32 quotient)."""
    q1 = xh / yh
    rh, rl = df_mul_f32(yh, yl, q1)
    rh, rl = df_add(xh, xl, -rh, -rl)
    q2 = (rh + rl) / yh
    return quick_two_sum(q1, q2)


def _pairwise_df(hi, lo):
    """Reduce (m,) df64 arrays to a scalar df64 by halving steps."""
    m = hi.shape[0]
    while m > 1:
        half = (m + 1) // 2
        pad = 2 * half - m
        if pad:
            hi = F.pad(hi, (0, pad))
            lo = F.pad(lo, (0, pad))
        hi, lo = df_add(hi[:half], lo[:half], hi[half:], lo[half:])
        m = half
    return hi[0], lo[0]


def df64_sum(x_hi, x_lo=None):
    """Compensated sum of an f32 array -> df64 scalar (hi, lo)."""
    x_hi = x_hi.reshape(-1)
    x_lo = (torch.zeros_like(x_hi) if x_lo is None else x_lo.reshape(-1))
    return _pairwise_df(x_hi, x_lo)


@register("df64_dot", "reference")
def df64_dot(x, y):
    """dot(x, y) of f32 vectors with df64 accumulation (Ogita dot2 with
    a full df64 tree: error ~ u^2 * n * cond).  Plain tensor code on any
    device (the reference's form is XLA code too, not a kernel)."""
    p, e = two_prod(x.reshape(-1), y.reshape(-1))
    return _pairwise_df(p, e)


@register("df64_norm2", "reference")
def df64_norm2(x):
    """||x||_2 as a df64 pair (hi, lo) — a single f32 cannot hold a
    better-than-6e-8 result; callers wanting a plain number use
    ``hi + lo`` in f64 or just hi."""
    h, l_ = df64_dot(x, x)
    # sqrt via one Newton step on the f32 sqrt, kept as hi+lo; the
    # square must be error-free (two_prod) or its rounding dominates
    s = torch.sqrt(h)
    p, e = two_prod(s, s)
    corr = torch.where(h > 0,
                       ((h - p) - e + l_) / (2 * torch.clamp_min(s, 1e-30)),
                       0.0)
    return quick_two_sum(s, corr.to(torch.float32))


def df64_dot_df(xh, xl, yh, yl):
    """dot of two df64 vectors."""
    ph, pe = df_mul(xh.reshape(-1), xl.reshape(-1), yh.reshape(-1),
                    yl.reshape(-1))
    return _pairwise_df(ph, pe)


# ---------------------------------------------------------------------------
# df64 banded (DIA) SpMV: y = A @ x with df64 x and df64 accumulation
# ---------------------------------------------------------------------------

def _shift(x, k):
    """y[i] = x[i + k] where 0 <= i + k < n, else 0."""
    return F.pad(x[k:], (0, k)) if k >= 0 else F.pad(x[:k], (-k, 0))


def dia_spmv_df64(offsets, dv, n, xh, xl):
    """y_(hi,lo) = A x for a banded matrix given as unblocked (D, n)
    f32 diagonal values (A[i, i+k] = dv[d, i]); per-element cost is one
    two_prod + one df64 add per diagonal."""
    yh = torch.zeros(n, dtype=torch.float32, device=xh.device)
    yl = torch.zeros(n, dtype=torch.float32, device=xh.device)
    for d, k in enumerate(offsets):
        k = int(k)
        # x shifted: contribution to y[i] is dv[d, i] * x[i + k]
        xs_h, xs_l = _shift(xh, k), _shift(xl, k)
        ph, pe = two_prod(dv[d], xs_h)
        pe = pe + dv[d] * xs_l
        yh, yl = df_add(yh, yl, *quick_two_sum(ph, pe))
    return yh, yl


def csr_spmv_df64(row_idx, col_idx, values, n, xh, xl):
    """General COO/CSR df64 SpMV: per-entry error-free two_prod, hi/lo
    segment sums.  The hi segment sum itself rounds at f32, so per-row
    accumulation error is ~ u * sqrt(row_nnz) (better than naive f32, not
    u^2); the banded and packed paths accumulate in full df64.  Rows
    ``>= n`` are padding."""
    g_h = xh[col_idx]
    g_l = xl[col_idx]
    ph, pe = two_prod(values, g_h)
    pe = pe + values * g_l
    rows = row_idx.long()
    yh = torch.zeros(n + 1, dtype=ph.dtype, device=ph.device).index_add_(
        0, rows, ph)[:n]
    # the hi sum's rounding is not recoverable from the segment sum; carry
    # the explicit error terms instead
    yl = torch.zeros(n + 1, dtype=pe.dtype, device=pe.device).index_add_(
        0, rows, pe)[:n]
    return quick_two_sum(yh, yl)


# ---------------------------------------------------------------------------
# Iterative refinement with df64 residuals (mixed-precision IR)
# ---------------------------------------------------------------------------

def _banded_parts(A):
    from .spmv_banded import unblock_diag_values
    meta = dict(A.band_meta)
    dv = unblock_diag_values(A.diag_values, meta).to(torch.float32)
    return tuple(int(k) for k in A.diag_offsets), dv, meta["n"]


def _tail_df64(A, n, xh, xl):
    return csr_spmv_df64(A.tail_rows, A.tail_cols,
                         A.tail_vals.to(torch.float32), n, xh, xl)


def _apply_df64(A, xh, xl):
    n = A.shape[0]
    if getattr(A, "strategy", None) == "banded" \
            and A.diag_values is not None:
        offsets, dv, n_ = _banded_parts(A)
        yh, yl = dia_spmv_df64(offsets, dv, n_, xh, xl)
        if A.tail_rows is not None:
            yh, yl = df_add(yh, yl, *_tail_df64(A, n_, xh, xl))
        return yh, yl
    if getattr(A, "strategy", None) == "packed" \
            and A.pell_vals is not None:
        yh, yl = pell_spmv_df64(A.pell_vals, A.pell_idx, A.pell_qw,
                                A.pell_xbase, A.pell_meta, xh, xl)
        if A.tail_rows is not None:
            yh, yl = df_add(yh, yl, *_tail_df64(A, n, xh, xl))
        return yh, yl
    return csr_spmv_df64(A.row_idx, A.col_idx, A.values.to(torch.float32),
                         n, xh, xl)


def ir_df64(A, b, inner_solve, iterations=4):
    """Solve A x = b to ~df64 residual accuracy with f32 storage and an
    f32 inner solver.  ``inner_solve(A, r) -> d`` (e.g. a CG solve
    returning ``.x``); a host loop of ``iterations`` sweeps.  Returns
    ((xh, xl), hist) where hist are the df64-evaluated residual norms per
    sweep."""
    b = torch.as_tensor(b).to(torch.float32).reshape(-1)
    xh = torch.zeros_like(b)
    xl = torch.zeros_like(b)
    hist = []
    for _ in range(int(iterations)):
        ah, al = _apply_df64(A, xh, xl)
        rh, rl = df_add(b, torch.zeros_like(b), -ah, -al)
        d = inner_solve(A, rh)
        xh, xl = df_add(xh, xl, *quick_two_sum(d, torch.zeros_like(d)))
        nh, nl = df64_norm2(rh + rl)
        hist.append(nh + nl)
    return (xh, xl), torch.stack(hist)


# ---------------------------------------------------------------------------
# df64 packed-slot SpMV: full df64 accumulation over the static (Wv, 8)
# slot axes of the windowed-ELL slab (ops/spmv_packed.py) — the
# general-unstructured analog of dia_spmv_df64.  Per element: one
# two_prod + the log2(Wv*8)-depth df64 tree.
# ---------------------------------------------------------------------------

def pell_spmv_df64(vals, idx, qw, xbase_row, meta_items, xh, xl):
    """y_(hi,lo) = A x for a packed-layout matrix with df64 x and df64
    accumulation, over the slab arrays (``Csr.pell_*``, kept on the
    host: moved to x's device here); f32 values."""
    from .spmv_packed import _BLOCKS_PER_SB, LANES, _pad_x
    meta = dict(meta_items)
    Gs, Wv, n = meta["Gs"], meta["Wv"], meta["n"]
    vals, idx, qw, xbase_row = (t.to(xh.device)
                                for t in (vals, idx, qw, xbase_row))
    qw2 = qw.reshape(Gs, _BLOCKS_PER_SB * Wv).long()
    xph = _pad_x(xh, meta).reshape(-1)
    xpl = _pad_x(xl, meta).reshape(-1)
    i64 = idx.long()
    row_abs = (xbase_row[:, None].long()
               + 8 * qw2)[:, :, None, None] + (i64 >> 7)
    flat = row_abs * LANES + (i64 & 127)
    v = vals.to(torch.float32)
    ph, pe = two_prod(v, xph[flat])
    pe = pe + v * xpl[flat]
    # df64 pairwise tree over the (Wv, 8) slot axes per (sb, block, lane)
    m = Wv * 8
    ph = ph.reshape(Gs, _BLOCKS_PER_SB, m, LANES)
    pe = pe.reshape(Gs, _BLOCKS_PER_SB, m, LANES)
    M = 1 << max(m - 1, 0).bit_length()
    if M != m:
        ph = F.pad(ph, (0, 0, 0, M - m))
        pe = F.pad(pe, (0, 0, 0, M - m))
    while M > 1:
        M //= 2
        ph, pe = df_add(ph[:, :, :M], pe[:, :, :M],
                        ph[:, :, M:2 * M], pe[:, :, M:2 * M])
    yh = ph[:, :, 0].reshape(Gs * _BLOCKS_PER_SB * LANES)[:n]
    yl = pe[:, :, 0].reshape(Gs * _BLOCKS_PER_SB * LANES)[:n]
    return yh, yl
