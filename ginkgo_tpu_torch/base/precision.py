"""Precision dispatch and version info (``ginkgo_tpu/base/precision.py``
in torch).

Analogs of ``include/ginkgo/core/base/precision_dispatch.hpp``
(``precision_dispatch_real_complex``: convert user vectors to the solver's
value type, solve, convert back) and ``version.hpp:132`` (version_info).
"""

from __future__ import annotations

import dataclasses

import torch


def precision_dispatch(solve_fn, A, b, *args, **kwargs):
    """Run ``solve_fn(A, b_converted, ...)`` with b converted to A's value
    type (and device), and return the result converted back to b's dtype
    — the temporary_conversion mechanism that lets an f32 solver accept
    f64 vectors (used at every solver apply boundary in the reference,
    ``core/solver/cg.cpp:84``)."""
    b = torch.as_tensor(b)
    res = solve_fn(A, b.to(device=A.device, dtype=A.dtype), *args,
                   **kwargs)
    if hasattr(res, "x"):
        return dataclasses.replace(res, x=res.x.to(b.dtype))
    return res.to(b.dtype)


def precision_dispatch_real_complex(solve_fn, A, b, *args, **kwargs):
    """Additionally handles complex b over a real operator by solving the
    real and imaginary parts as a 2-column multivector
    (``precision_dispatch_real_complex`` analog)."""
    b = torch.as_tensor(b)
    if b.is_complex() and not A.dtype.is_complex:
        b2 = b[:, None] if b.ndim == 1 else b
        stacked = torch.cat([b2.real, b2.imag], dim=1)
        res = solve_fn(A, stacked.to(device=A.device, dtype=A.dtype), *args,
                       **kwargs)
        k = stacked.shape[1] // 2
        x = torch.complex(res.x[:, :k], res.x[:, k:])
        return dataclasses.replace(
            res, x=(x[:, 0] if b.ndim == 1 else x).to(b.dtype))
    return precision_dispatch(solve_fn, A, b, *args, **kwargs)


class version_info:
    """``gko::version_info::get()`` analog."""

    @staticmethod
    def get():
        from .. import __version__
        return {
            "ginkgo_tpu_torch": __version__,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            # entry points place their tensors here unless asked otherwise
            "backend": "cuda" if torch.cuda.is_available() else "none",
            "tiers": {"reference": "torch", "cuda": "nvcc sm_90a",
                      "host": "c++ (native/)"},
        }
