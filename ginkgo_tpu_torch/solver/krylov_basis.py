"""Krylov basis storage accessors (``ginkgo_tpu/solver/krylov_basis.py`` in
torch).

Used by GMRES (the Krylov basis, incl. the CB-GMRES compressed-storage
variants, ``core/solver/cb_gmres_accessor.hpp:56-115``).  As in the JAX
package:

* k == 1 state is stored squeezed 2-D, (m_pad, n); otherwise (m_pad, n, k);
* the row axis is padded to a multiple of the caller's orthogonalisation
  block, ``m_pad = ceil(m, block)``.

Unlike the JAX package, which threads the store functionally, ``write``
mutates the store in place and returns the same tensor, so the solver never
copies the basis.  On a CUDA store the row write is kernel F
(``ops/csrc/row_write.cu``); on a CPU store it is ``store[i].copy_(row)``.

``write`` takes an optional (k,) bool ``sel``: for k > 1, only the selected
columns of the row are written and the others keep what the store holds,
so a column frozen by its stopping criterion keeps its basis while the
others go on.
"""

from __future__ import annotations

import torch

from ..base.dtypes import as_torch_dtype, reduce_precision
from ..device import resolve_device
from ..ops.registry import lookup


def _ceil_to(m: int, block: int) -> int:
    return -(-m // block) * block


def inplace_row_write(store, i, row):
    """store[i] = row in place (the row cast to the store's dtype first);
    returns ``store``.  Kernel F on a CUDA store, ``copy_`` on the CPU."""
    row = row.to(store.dtype).contiguous()
    return lookup("row_write", store.device)(store, int(i), row)


class _SqueezeK1:
    """k == 1 pack/unpack between the solver's (n, k) vectors and the
    squeezed 2-D storage."""

    def _pack(self, vec):
        return vec[:, 0] if self.k1 else vec

    def _unpack(self, arr):
        return arr[..., None] if self.k1 else arr


class KrylovBasis(_SqueezeK1):
    """'keep': basis stored at full value-type precision."""

    def __init__(self, m, n, k, dtype, block=1, device=None):
        self.k1 = (k == 1)
        m_pad = _ceil_to(m, block)
        self.shape = (m_pad, n) if self.k1 else (m_pad, n, k)
        self.dtype = as_torch_dtype(dtype)
        self.device = resolve_device(device)

    def empty(self):
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)

    def write(self, store, i, vec, sel=None):
        row = self._pack(vec)
        if sel is not None and not self.k1:
            row = torch.where(sel, row.to(self.dtype), store[i])
        return inplace_row_write(store, i, row)

    def read_one(self, store, i, dtype):
        return self._unpack(store[i].to(dtype))

    def read_block(self, store, start, size, dtype):
        """(size, n, k) columns [start, start+size)."""
        return self._unpack(store[start:start + size].to(dtype))


class ReducedBasis(KrylovBasis):
    """reduce1/reduce2: plain down-converted storage (f64->f32->bf16)."""

    def __init__(self, m, n, k, dtype, steps, block=1, device=None):
        store = as_torch_dtype(dtype)
        for _ in range(steps):
            store = reduce_precision(store)
        super().__init__(m, n, k, store, block=block, device=device)


class ScaledIntBasis(_SqueezeK1):
    """integer: per-vector-scaled integer storage (Ginkgo's scaled
    ``reduced_row_major`` with integer storage, mask 0b101).  'integer'
    maps to int16 (Ginkgo's wider int modes); 'int8' is the aggressive
    quarter-traffic variant."""

    def __init__(self, m, n, k, dtype, int_dtype=torch.int16, block=1,
                 device=None):
        self.k = k
        self.k1 = (k == 1)
        m_pad = _ceil_to(m, block)
        self.shape = (m_pad, n) if self.k1 else (m_pad, n, k)
        self.value_dtype = as_torch_dtype(dtype)
        self.int_dtype = int_dtype
        self.qmax = float(torch.iinfo(int_dtype).max - 1)
        self.device = resolve_device(device)

    def empty(self):
        return dict(q=torch.zeros(self.shape, dtype=self.int_dtype,
                                  device=self.device),
                    scale=torch.ones((self.shape[0], self.k),
                                     dtype=self.value_dtype,
                                     device=self.device))

    def write(self, store, i, vec, sel=None):
        amax = torch.amax(torch.abs(vec), dim=0)
        scale = torch.where(amax == 0, torch.ones_like(amax),
                            amax / self.qmax)
        q = torch.clamp(torch.round(vec / scale[None, :]),
                        -self.qmax, self.qmax).to(self.int_dtype)
        scale = scale.to(store["scale"].dtype)
        q = self._pack(q)
        if sel is not None and not self.k1:
            q = torch.where(sel, q, store["q"][i])
            scale = torch.where(sel, scale, store["scale"][i])
        inplace_row_write(store["q"], i, q)
        store["scale"][i] = scale
        return store

    def _scaled(self, q, s, dtype):
        """q: (..., n[, k]) ints, s: (..., k) scales -> values (..., n, k)."""
        return self._unpack(q.to(dtype)) * s[..., None, :].to(dtype)

    def read_one(self, store, i, dtype):
        return (self._unpack(store["q"][i].to(dtype))
                * store["scale"][i][None].to(dtype))

    def read_block(self, store, start, size, dtype):
        return self._scaled(store["q"][start:start + size],
                            store["scale"][start:start + size], dtype)


def make_basis(storage, m, n, k, dtype, block=1, device=None):
    if storage in (None, "keep"):
        return KrylovBasis(m, n, k, dtype, block=block, device=device)
    if storage == "reduce1":
        return ReducedBasis(m, n, k, dtype, 1, block=block, device=device)
    if storage == "reduce2":
        return ReducedBasis(m, n, k, dtype, 2, block=block, device=device)
    if storage == "integer":
        return ScaledIntBasis(m, n, k, dtype, torch.int16, block=block,
                              device=device)
    if storage == "int8":
        return ScaledIntBasis(m, n, k, dtype, torch.int8, block=block,
                              device=device)
    # an explicit dtype
    return KrylovBasis(m, n, k, as_torch_dtype(storage), block=block,
                       device=device)
