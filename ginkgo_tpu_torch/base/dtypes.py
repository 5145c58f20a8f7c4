"""Value type helpers (``ginkgo_tpu/base/dtypes.py`` over torch dtypes).

Every helper takes a torch dtype or anything numpy reads as a dtype
(``np.float32``, ``"float64"``), so host planning code and device code
share one vocabulary.
"""

from __future__ import annotations

import numpy as np
import torch


def as_torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of ``dtype`` (a torch dtype or a numpy-style one)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def is_complex(dtype) -> bool:
    return as_torch_dtype(dtype).is_complex


def complex_dtype(dtype) -> torch.dtype:
    """The complex counterpart of a value type: complex64 for f32, bf16
    and f16, complex128 for f64; a complex type is its own."""
    d = as_torch_dtype(dtype)
    if d.is_complex:
        return d
    return (torch.complex64
            if d in (torch.float32, torch.bfloat16, torch.float16)
            else torch.complex128)


def real_dtype(dtype) -> torch.dtype:
    """The real counterpart of a value type (f32 for c64, etc.)."""
    d = as_torch_dtype(dtype)
    return d.to_real() if d.is_complex else d


def eps(dtype) -> float:
    """Machine epsilon of the *real* part of the value type."""
    return float(torch.finfo(real_dtype(dtype)).eps)


_REDUCE_LADDER = {
    torch.float64: torch.float32,
    torch.float32: torch.bfloat16,
    torch.bfloat16: torch.bfloat16,
    torch.float16: torch.float16,
    torch.complex128: torch.complex64,
    torch.complex64: torch.complex64,
}


def reduce_precision(dtype) -> torch.dtype:
    """One step down Ginkgo's precision ladder (f64->f32->bf16),
    used by CB-GMRES's compressed Krylov basis."""
    return _REDUCE_LADDER[as_torch_dtype(dtype)]
