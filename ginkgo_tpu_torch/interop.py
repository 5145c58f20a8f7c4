"""Carry a planned matrix across from another implementation.

For this system the "weights" are the planned operator: ``csr_from_arrays``
takes the arrays and static fields of a ``Csr`` planned elsewhere (for
instance ``ginkgo_tpu``'s, read out as numpy) and returns the port's
``Csr`` holding the same layout, without planning again.  Both packages
then run on identical operators.  ``factorization_from_arrays`` does the
same for the two factors of an incomplete factorization.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .matrix.csr import Csr

INDEX_ARRAYS = ("row_ptr", "col_idx", "row_idx", "tail_rows", "tail_cols")
VALUE_ARRAYS = ("values", "diag_values", "tail_vals", "pell_vals")
LAYOUT_INDEX_ARRAYS = {"pell_idx": torch.int16, "pell_qw": torch.int32,
                       "pell_xbase": torch.int32}
STATIC_FIELDS = ("shape", "nnz", "strategy", "diag_offsets", "band_meta",
                 "pell_meta")


def csr_from_arrays(arrays: dict, static: dict, device=None,
                    index_dtype=torch.int32) -> Csr:
    """``arrays``: name -> numpy array (absent or None where the layout has
    none); ``static``: the fields of ``STATIC_FIELDS``.  The tensors are
    placed on ``device`` (``None``: the CUDA device)."""
    device = resolve_device(device)
    kw = {name: static.get(name) for name in STATIC_FIELDS}
    kw["shape"] = tuple(int(s) for s in kw["shape"])

    def put(name, dtype):
        arr = arrays.get(name)
        if arr is not None:
            # np.array copies: arrays read out of another framework are
            # often read-only, which torch.from_numpy does not accept
            kw[name] = torch.from_numpy(np.array(arr)).to(device=device,
                                                          dtype=dtype)

    for name in INDEX_ARRAYS:
        put(name, index_dtype)
    for name in VALUE_ARRAYS:
        put(name, None)
    for name, dtype in LAYOUT_INDEX_ARRAYS.items():
        put(name, dtype)
    return Csr(**kw)


def factorization_from_arrays(l_factor, u_factor, symmetric=False,
                              device=None, index_dtype=torch.int32):
    """A factorization computed elsewhere, without factorizing again:
    ``l_factor`` and ``u_factor`` are each the ``(arrays, static)`` of one
    factor's Csr, as ``csr_from_arrays`` takes them; ``symmetric`` marks an
    IC pair (U = Lᴴ).  ``Ilu(factorization=F)`` / ``Ic(factorization=F)``
    accept the result as they accept a generated one."""
    from .factorization.container import Factorization
    L = csr_from_arrays(*l_factor, device=device, index_dtype=index_dtype)
    U = csr_from_arrays(*u_factor, device=device, index_dtype=index_dtype)
    return Factorization(l_factor=L, u_factor=U, symmetric=symmetric)
