"""In-place write of one Krylov-basis row, ``store[i] = row``: the
counterpart of the Pallas kernel ``kern`` of
``ginkgo_tpu/solver/krylov_basis.py::_row_write_call``.

The store is a contiguous (m_pad, n) or (m_pad, n, k) tensor and is
mutated in place; the row has the store's dtype and the shape of one of
its rows.  On a CUDA store the write is the hand-written kernel
``csrc/row_write.cu`` (TMA bulk copies through a ring in shared memory,
the ragged ends in scalar code); on a CPU store it is the plain
``store[i].copy_(row)``.

The JAX package keeps its Pallas write behind ``GINKGO_TPU_PALLAS_WRITE=1``
because on the TPU the (m, n) <-> (m*n/128, 128) reshape around the
aliased call is a re-tiling copy.  Nothing like it exists on the card, so
here the kernel is the basis write whenever the store is on CUDA.
"""

from __future__ import annotations

import torch

from . import _cuda
from .registry import register


@register("row_write", "reference")
def row_write_reference(store, i, row):
    """Plain version: ``store[i].copy_(row)``; returns ``store``."""
    store[i].copy_(row)
    return store


@register("row_write", "cuda")
def row_write_cuda(store, i, row):
    """``store[i] = row`` in place on the CUDA kernel; returns ``store``.

    A store on the CPU takes the plain version; on a CUDA device this
    launches the kernel or raises — it never falls back."""
    if store.device.type != "cuda":
        return row_write_reference(store, i, row)
    if row.dtype != store.dtype:
        raise TypeError(f"row_write: row dtype {row.dtype} != store dtype "
                        f"{store.dtype}; cast the row first")
    if row.device != store.device:
        raise ValueError("row_write: store and row must share one device")
    if not (store.is_contiguous() and row.is_contiguous()):
        raise ValueError("row_write: store and row must be contiguous")
    if store.ndim < 2 or tuple(row.shape) != tuple(store.shape[1:]):
        raise ValueError(f"row_write: row {tuple(row.shape)} is not a row "
                         f"of store {tuple(store.shape)}")
    i = int(i)
    if not 0 <= i < store.shape[0]:
        raise IndexError(f"row_write: row {i} outside store of "
                         f"{store.shape[0]} rows")
    esize = store.element_size()
    if esize not in (1, 2, 4, 8, 16):
        raise TypeError(f"row_write: element size {esize} (dtype "
                        f"{store.dtype}) is not 1, 2, 4, 8 or 16 bytes")
    n = row.numel()
    if n == 0:
        return store
    lib = _cuda.library("row_write")
    with torch.cuda.device(store.device):
        stream = torch.cuda.current_stream(store.device).cuda_stream
        code = lib.row_write_launch(store.data_ptr() + i * n * esize,
                                    row.data_ptr(), n, esize, stream)
    _cuda.check("row_write", code)
    row_write_cuda.launches += 1
    return store


row_write_cuda.launches = 0    # kernel launches since the last reset
