"""Implicit differentiation of linear solves (``ginkgo_tpu/autodiff.py`` in
torch).

Ginkgo has no autodiff; the JAX package makes ``x = A^{-1} b``
differentiable through its Krylov loops by the implicit function theorem,
and so does this module, as a ``torch.autograd.Function``:

    dL/db      =  A^{-H} g            (one adjoint solve)
    dL/dA_ij   = -(A^{-H} g)_i conj(x_j)   (restricted to A's pattern)

where ``g`` is the gradient torch hands back for ``x``.  That is torch's
convention for complex values (the gradients of ``torch.linalg.solve``);
JAX's cotangents are their conjugates.  The adjoint solve reuses the same
solver on ``A.conj_transpose()``.

Gradients go to ``b`` and to the value tensors of ``A``, each in its own
buffer's layout: ``values`` of a ``Coo`` or of a classical or packed
``Csr``; for a banded ``Csr`` zeros in ``values`` (its apply never reads
them), the on-band entries in ``diag_values`` (the blocked layout) and the
off-band ones in ``tail_vals``, in canonical order; ``data`` of a
``Dense``.  Mark the tensors whose gradients you want with
``requires_grad_()`` and read ``.grad`` after ``backward()``.
"""

from __future__ import annotations

import torch

from .matrix.coo import Coo
from .matrix.csr import Csr
from .matrix.dense import Dense


def _conj_transpose(A):
    return A.conj_transpose() if hasattr(A, "conj_transpose") else A


def _value_fields(A):
    """The names of A's value tensors, in the order the function takes
    them."""
    if isinstance(A, Csr):
        return tuple(name for name in ("values", "diag_values", "tail_vals")
                     if getattr(A, name) is not None)
    if isinstance(A, Coo):
        return ("values",)
    if isinstance(A, Dense):
        return ("data",)
    raise NotImplementedError(
        f"implicit gradients not implemented for {type(A).__name__}")


class _ImplicitSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, solve_fn, solve_kwargs, b, *values):
        x = solve_fn(A, b, **solve_kwargs).x
        ctx.A, ctx.solve_fn, ctx.solve_kwargs = A, solve_fn, solve_kwargs
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        A = ctx.A
        lam = ctx.solve_fn(_conj_transpose(A), g, **ctx.solve_kwargs).x
        grads = _grad_wrt_operator(A, lam, x)
        return (None, None, None, lam,
                *(grads[name] for name in _value_fields(A)))


def make_differentiable_solve(solve_fn, **solve_kwargs):
    """Wrap a ``solve(A, b, ...)`` function into ``f(A, b) -> x`` that
    autograd differentiates by implicit differentiation.

    Gradients flow to ``b`` and to ``A``'s value tensors (pattern fixed).
    """

    def solve(A, b):
        values = [getattr(A, name) for name in _value_fields(A)]
        return _ImplicitSolve.apply(A, solve_fn, solve_kwargs, b, *values)

    return solve


def _grad_wrt_operator(A, lam, x):
    """dL/dA = -lam x^H restricted to A's stored entries: {name: gradient}
    for each of A's value tensors."""
    lam2 = lam[:, None] if lam.ndim == 1 else lam
    x2 = (x[:, None] if x.ndim == 1 else x).conj()
    if isinstance(A, Dense):
        return {"data": (-lam2 @ x2.T).to(A.data.dtype)}
    n, m = A.shape
    rows, cols = A.row_idx.long(), A.col_idx.long()
    valid = rows < n
    r = rows.clamp(max=n - 1)
    c = cols.clamp(max=m - 1)
    gvals = torch.where(valid, -(lam2[r] * x2[c]).sum(dim=1), 0)
    # every value tensor but the one the gradient lands in gets zeros (a
    # packed Csr's tail, say: its gradient is in `values`, as the
    # reference's is)
    out = {name: torch.zeros_like(getattr(A, name))
           for name in _value_fields(A)}
    if not (isinstance(A, Csr) and A.diag_values is not None):
        out["values"] = gvals.to(A.values.dtype)
        return out
    # the banded forward never reads the COO `values` buffer: its true
    # gradient is zero, and everything flows to the diagonal and tail
    # buffers.  On-band entries go to their (diagonal, row) slot of the
    # blocked layout; off-band (tail) entries keep their canonical order
    # in both the full arrays and the tail arrays, so a prefix sum places
    # them.
    from .ops.spmv_banded import block_diag_values
    meta = dict(A.band_meta)
    offs = torch.tensor(A.diag_offsets, device=rows.device)
    D = offs.shape[0]
    delta = cols - rows
    d_of = torch.searchsorted(offs, delta).clamp(0, D - 1)
    on_band = (offs[d_of] == delta) & valid
    flat = torch.zeros((D, meta["n"]), dtype=gvals.dtype, device=gvals.device)
    flat[d_of[on_band], rows[on_band]] = gvals[on_band]
    out["diag_values"] = block_diag_values(flat, meta).to(
        A.diag_values.dtype)
    if A.tail_vals is not None:
        is_tail = ~on_band & valid
        slot = torch.cumsum(is_tail.to(torch.int64), dim=0) - 1
        tail = torch.zeros_like(A.tail_vals, dtype=gvals.dtype)
        tail[slot[is_tail]] = gvals[is_tail]
        out["tail_vals"] = tail.to(A.tail_vals.dtype)
    return out
