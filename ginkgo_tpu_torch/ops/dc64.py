"""Double-word complex ("dc64") arithmetic (``ginkgo_tpu/ops/dc64.py`` in
torch).

A dc64 value is a pair of df64 components ``(re_hi, re_lo, im_hi,
im_lo)``, and every operation is the textbook complex composition of the
error-free df64 operations of ``df64.py`` — no new numerics, the df64
error analysis applies per component.

Provided: dc64 add/mul, conjugating dot + norm, banded (DIA) SpMV with
full dc64 accumulation (4 ``dia_spmv_df64`` plane passes), and
``ir_dc64`` — complex iterative refinement with the residual evaluated
in dc64: complex64 inner solves + dc64 residuals converge to ~1e-12
complex relative residuals.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .df64 import df64_dot_df, df_add, df_mul, dia_spmv_df64


def dc_add(a, b):
    """(4-tuple) + (4-tuple)."""
    rh, rl = df_add(a[0], a[1], b[0], b[1])
    ih, il = df_add(a[2], a[3], b[2], b[3])
    return rh, rl, ih, il


def dc_neg(a):
    return -a[0], -a[1], -a[2], -a[3]


def dc_mul(a, b):
    """Complex product: (ar br - ai bi) + i (ar bi + ai br)."""
    t1 = df_mul(a[0], a[1], b[0], b[1])
    t2 = df_mul(a[2], a[3], b[2], b[3])
    t3 = df_mul(a[0], a[1], b[2], b[3])
    t4 = df_mul(a[2], a[3], b[0], b[1])
    rh, rl = df_add(t1[0], t1[1], -t2[0], -t2[1])
    ih, il = df_add(t3[0], t3[1], t4[0], t4[1])
    return rh, rl, ih, il


def dc_from_c64(z, device=None):
    """c64/c128 array -> dc64 4-tuple of f32 tensors (hi/lo split), split
    on the host and placed on ``device`` (default: a tensor's own device,
    else the card)."""
    if isinstance(z, torch.Tensor):
        device = z.device if device is None else device
        z = z.cpu().numpy()
    device = resolve_device(device)
    zr = np.asarray(np.real(np.asarray(z)), np.float64)
    zi = np.asarray(np.imag(np.asarray(z)), np.float64)
    rh = zr.astype(np.float32)
    rl = (zr - rh.astype(np.float64)).astype(np.float32)
    ih = zi.astype(np.float32)
    il = (zi - ih.astype(np.float64)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (rh, rl, ih, il))


def dc_to_c128(a):
    """dc64 4-tuple -> host complex128."""
    f = [np.asarray(t.cpu().numpy() if isinstance(t, torch.Tensor) else t,
                    np.float64) for t in a]
    return f[0] + f[1] + 1j * (f[2] + f[3])


def dc64_dot(x, y):
    """Conjugating dot <x, y> = sum conj(x_e) y_e of dc64 vectors; both
    are 4-tuples of equal-shape f32 tensors.  Returns a dc64 scalar."""
    xr, xl, xi, xil = x
    yr, yl, yi, yil = y
    # re = sum xr*yr + xi*yi ; im = sum xr*yi - xi*yr
    a = df_add(*df64_dot_df(xr, xl, yr, yl),
               *df64_dot_df(xi, xil, yi, yil))
    c = df64_dot_df(xi, xil, yr, yl)
    b = df_add(*df64_dot_df(xr, xl, yi, yil), -c[0], -c[1])
    return a[0], a[1], b[0], b[1]


def dc64_norm2(x):
    """||x||_2 of a dc64 vector (f32 scalar carrying ~df64 accuracy via
    one Newton step on the df64 dot)."""
    rh, rl, _, _ = dc64_dot(x, x)             # imag ~ 0
    v = rh + rl
    s = torch.sqrt(torch.clamp_min(rh, 0.0))
    return torch.where(s > 0, 0.5 * (s + v / torch.where(s > 0, s, 1.0)),
                       0.0)


def dia_spmv_dc64(offsets, dv_re, dv_im, n, x):
    """y = A x for a banded complex matrix given as f32 re/im diagonal
    planes ((D, n), unblocked), dc64 x — 4 df64 plane passes with full
    dc64 accumulation."""
    rr = dia_spmv_df64(offsets, dv_re, n, x[0], x[1])
    ii = dia_spmv_df64(offsets, dv_im, n, x[2], x[3])
    ri = dia_spmv_df64(offsets, dv_re, n, x[2], x[3])
    ir = dia_spmv_df64(offsets, dv_im, n, x[0], x[1])
    re = df_add(rr[0], rr[1], -ii[0], -ii[1])
    im = df_add(ri[0], ri[1], ir[0], ir[1])
    return re[0], re[1], im[0], im[1]


def ir_dc64(offsets, dv_re, dv_im, n, b, inner_solve, iterations=4):
    """Solve the banded complex system A x = b to ~dc64 residual
    accuracy.  ``inner_solve(r_re, r_im) -> (d_re, d_im)`` is an f32
    approximate complex solve (e.g. complex64 BiCGSTAB); the residual is
    evaluated in dc64 each sweep, a host loop of ``iterations``.  ``b``
    is a dc64 4-tuple (use ``dc_from_c64``).  Returns (x dc64, per-sweep
    dc64 residual norms)."""
    offsets = tuple(int(k) for k in offsets)
    x = tuple(torch.zeros(n, dtype=torch.float32, device=dv_re.device)
              for _ in range(4))
    hist = []
    for _ in range(int(iterations)):
        ax = dia_spmv_dc64(offsets, dv_re, dv_im, n, x)
        r = dc_add(b, dc_neg(ax))
        d = inner_solve(r[0] + r[1], r[2] + r[3])   # f32 re/im planes
        x = dc_add(x, (d[0], torch.zeros_like(d[0]),
                       d[1], torch.zeros_like(d[1])))
        hist.append(dc64_norm2(r))
    return x, torch.stack(hist)
