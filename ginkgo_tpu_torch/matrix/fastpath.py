"""Shared SpMV fast path for the non-CSR format zoo
(``ginkgo_tpu/matrix/fastpath.py`` in torch).

The reference ships a tuned SpMV kernel per format
(``common/cuda_hip/matrix/{coo,ell,sellp}_kernels.cpp``, hybrid split
``include/ginkgo/core/matrix/hybrid.hpp:42``).  The JAX package, and the
port with it, has *one* pair of layouts — banded DIA (kernel A,
``ops/csrc/dia_spmv.cu``) and packed-slot windowed-ELL (kernel B,
``ops/csrc/sell_spmv.cu`` over the slab's compact stream) — that every
format plans into at build time.  Ell is a degenerate packed layout,
Hybrid's ELL+COO split is exactly packed+tail, Sellp/Coo/Fbcsr route by
conversion — so instead of a kernel per format, each format builds a
``SpmvPlan`` aux operator and delegates its ``_apply`` to it.

The format's own arrays remain the canonical storage (conversions,
``to_matrix_data``, scaling); the plan is a device-side acceleration
cache that holds what a planned ``Csr`` holds: the banded diagonals, or
the packed slab on the host and its compact stream on the device, plus
the COO tail.  Pass ``fast=False`` to ``from_data`` to opt out.
"""

from __future__ import annotations

import torch

from ..base.linop import LinOp


class SpmvPlan(LinOp):
    """Banded/packed layout + COO tail, no classical storage.

    Internal-only operator: carries exactly the aux arrays the fast
    kernels need (the attribute names of ``Csr``'s, so
    ``csr.fast_spmv_apply`` serves both).  Not a full format — no
    conversions, no classical fallback."""

    def __init__(self, shape, strategy, device, diag_offsets=None,
                 band_meta=None, diag_values=None, tail_rows=None,
                 tail_cols=None, tail_vals=None, pell_meta=None,
                 pell_vals=None, pell_idx=None, pell_qw=None,
                 pell_xbase=None):
        from .csr import set_packed
        self.shape = tuple(shape)
        self.strategy = strategy
        self.diag_offsets = diag_offsets
        self.band_meta = band_meta
        self.diag_values = diag_values
        self.tail_rows = tail_rows
        self.tail_cols = tail_cols
        self.tail_vals = tail_vals
        set_packed(self, pell_meta, (pell_vals, pell_idx, pell_qw,
                                     pell_xbase), torch.device(device))

    def _apply(self, b):
        from .csr import fast_spmv_apply
        y = fast_spmv_apply(self, b)
        if y is None:  # pragma: no cover - plan is only built when accepted
            raise RuntimeError("SpmvPlan built without a fast layout")
        return y


def plan_fast_spmv(d, dtype=None, index_dtype=torch.int32, device=None):
    """Run the CSR ``automatical`` acceptance on canonical data and return
    a :class:`SpmvPlan` (banded or packed) on ``device``, or ``None`` when
    neither layout is economical (the format then keeps its own gather
    path).  ``dtype`` (default: the data's) is the value type on the
    device; the host plans in the numpy type ``host_value_types`` gives
    for it, as ``Csr.from_data`` does."""
    from ..device import resolve_device
    from .csr import (_process_strategy, _upload, aux_device_kw,
                      host_value_types)
    device = resolve_device(device)
    vdtype, host = host_value_types(d.values.dtype, dtype)
    (strategy, diag_offsets, band_meta, diag_values,
     tail, pell) = _process_strategy("automatical", d,
                                     d.values.astype(host, copy=False))
    if strategy == "classical":
        return None
    kw = aux_device_kw(d.shape[0], vdtype, index_dtype, tail, pell, device)
    return SpmvPlan(shape=d.shape, strategy=strategy, device=device,
                    diag_offsets=diag_offsets, band_meta=band_meta,
                    diag_values=None if diag_values is None
                    else _upload(diag_values, device, vdtype), **kw)
