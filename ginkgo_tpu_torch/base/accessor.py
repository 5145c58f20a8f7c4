"""Accessors — storage/arithmetic precision decoupling
(``ginkgo_tpu/base/accessor.py`` in torch).

Analog of Ginkgo's ``accessor/`` templates (``reduced_row_major.hpp``,
``scaled_reduced_row_major.hpp``, ``range.hpp``): arrays stored at a lower
precision (or scaled integers) but *read and written* in a higher
arithmetic type — the quantise/dequantise pair around a device buffer
(storage traffic halves or quarters while the arithmetic stays in the
arithmetic type; the CB-GMRES basis trick).

Accessors are values, as in the reference: ``write`` returns a new
accessor and leaves the old one unchanged.
"""

from __future__ import annotations

import torch

from ..device import resolve_device


class ReducedRowMajor:
    """Plain down-converted storage: read() upcasts, write() downcasts."""

    def __init__(self, storage, arith_dtype=torch.float32):
        self.storage = storage
        self.arith_dtype = arith_dtype

    @classmethod
    def create(cls, shape, storage_dtype, arith_dtype=torch.float32,
               device=None):
        return cls(torch.zeros(shape, dtype=storage_dtype,
                               device=resolve_device(device)), arith_dtype)

    @classmethod
    def from_array(cls, arr, storage_dtype):
        arr = torch.as_tensor(arr)
        return cls(arr.to(storage_dtype), arr.dtype)

    @property
    def shape(self):
        return tuple(self.storage.shape)

    def read(self, idx=None):
        s = self.storage if idx is None else self.storage[idx]
        return s.to(self.arith_dtype)

    def write(self, idx, value):
        storage = self.storage.clone()
        storage[idx] = value.to(storage.dtype)
        return ReducedRowMajor(storage, self.arith_dtype)


class ScaledReducedRowMajor:
    """Scaled integer storage: value = scale[row-block] * q.  The scale is
    per leading index (Ginkgo's stride mask 0b101 layout)."""

    def __init__(self, q, scale, arith_dtype=torch.float32):
        self.q = q                # integer storage
        self.scale = scale        # (leading_dim,) arithmetic dtype
        self.arith_dtype = arith_dtype

    @classmethod
    def create(cls, shape, int_dtype=torch.int16, arith_dtype=torch.float32,
               device=None):
        device = resolve_device(device)
        return cls(torch.zeros(shape, dtype=int_dtype, device=device),
                   torch.ones((shape[0],), dtype=arith_dtype, device=device),
                   arith_dtype)

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def _qmax(self):
        return float(torch.iinfo(self.q.dtype).max - 1)

    def read(self, i=None):
        if i is None:
            sc = self.scale.reshape((-1,) + (1,) * (self.q.ndim - 1))
            return self.q.to(self.arith_dtype) * sc.to(self.arith_dtype)
        return (self.q[i].to(self.arith_dtype)
                * self.scale[i].to(self.arith_dtype))

    def write(self, i, value):
        """Write one leading-index slice, choosing its scale from |max|."""
        amax = torch.max(torch.abs(value))
        scale = torch.where(amax == 0, torch.ones_like(amax),
                            amax / self._qmax)
        qv = torch.clamp(torch.round(value / scale), -self._qmax,
                         self._qmax).to(self.q.dtype)
        q = self.q.clone()
        q[i] = qv
        sc = self.scale.clone()
        sc[i] = scale.to(sc.dtype)
        return ScaledReducedRowMajor(q, sc, self.arith_dtype)
