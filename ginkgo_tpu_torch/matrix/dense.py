"""Dense row-major operator + multivector BLAS
(``ginkgo_tpu/matrix/dense.py`` in torch).

Analog of Ginkgo's ``matrix::Dense`` (``include/ginkgo/core/matrix/dense.hpp:88``,
BLAS ops :962-1121).  Plain tensors are the multivector, so the BLAS-1
surface is free functions over (n, k) tensors (used by solvers with
per-column stopping masks); ``Dense`` itself is the dense *operator*
whose apply is a ``torch.matmul`` (bf16 and f16 accumulate in f32).
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.dtypes import as_torch_dtype
from ..base.linop import LinOp
from ..base.matrix_data import MatrixData
from ..device import resolve_device
from ..ops.registry import lookup


class Dense(LinOp):
    def __init__(self, data):
        self.data = data    # (n, m) tensor

    @property
    def shape(self):
        return tuple(self.data.shape)

    def _apply(self, b):
        acc = _acc_dtype(self.data.dtype)
        return lookup("dense_spmv", b.device)(
            self.data.to(acc), b.to(self.data.dtype).to(acc))

    def _apply_advanced(self, alpha, b, beta, x):
        return alpha * self._apply(b) + beta * x

    # -- construction -------------------------------------------------------
    @classmethod
    def from_data(cls, data: MatrixData, dtype=None, device=None):
        """``data`` as a dense tensor on ``device`` (``None``: the CUDA
        device; raises when there is none)."""
        return cls.create(data.canonical().to_dense(), dtype=dtype,
                          device=device)

    @classmethod
    def create(cls, array, dtype=None, device=None):
        device = resolve_device(device)
        if isinstance(array, torch.Tensor):
            t = array
        else:
            arr = np.asarray(array)
            if dtype is not None and as_torch_dtype(dtype) != torch.bfloat16:
                arr = arr.astype(torch.empty(0, dtype=as_torch_dtype(
                    dtype)).numpy().dtype, copy=False)
            t = torch.from_numpy(np.ascontiguousarray(arr))
        if dtype is not None:
            t = t.to(as_torch_dtype(dtype))
        return cls(t.to(device))

    # -- ops ------------------------------------------------------------------
    def to_dense(self):
        return self.data

    def transpose(self):
        return Dense(self.data.T)

    def conj_transpose(self):
        return Dense(self.data.conj_physical().T)

    def extract_diagonal(self):
        from .diagonal import Diagonal
        return Diagonal(torch.diagonal(self.data))

    # multivector BLAS as methods (dense.hpp:962-1121 parity spelling)
    def compute_dot(self, other):
        return compute_dot(self.data, _data_of(other))

    def compute_conj_dot(self, other):
        return compute_conj_dot(self.data, _data_of(other))

    def compute_norm2(self):
        return compute_norm2(self.data)

    def compute_norm1(self):
        return compute_norm1(self.data)

    def compute_mean(self):
        return compute_mean(self.data)

    def compute_squared_norm2(self):
        return compute_squared_norm2(self.data)

    def scale(self, alpha):
        return Dense(self.data * alpha)

    def inv_scale(self, alpha):
        return Dense(self.data / alpha)

    def add_scaled(self, alpha, other):
        return Dense(self.data + alpha * _data_of(other))

    def sub_scaled(self, alpha, other):
        return Dense(self.data - alpha * _data_of(other))

    def add_scaled_identity(self, alpha, beta):
        """``beta*self + alpha*I`` (ScaledIdentityAddable,
        ``lin_op.hpp:818-838``; functional: returns the new operator)."""
        n, m = self.shape
        eye = torch.eye(n, m, dtype=self.data.dtype, device=self.data.device)
        return Dense(beta * self.data + alpha * eye)

    def compute_absolute(self):
        """|self| entrywise (AbsoluteComputable, ``dense.hpp:816-818``)."""
        return Dense(torch.abs(self.data))

    def make_complex(self):
        """Promote to the matching complex value type (``dense.hpp:820+``)."""
        from ..base.dtypes import complex_dtype
        return Dense(self.data.to(complex_dtype(self.data.dtype)))

    def get_real(self):
        return Dense(torch.real(self.data).clone())

    def get_imag(self):
        if not self.data.is_complex():
            return Dense(torch.zeros_like(self.data))
        return Dense(torch.imag(self.data).clone())

    def fill(self, value):
        return Dense(torch.full_like(self.data, value))

    def row_gather(self, rows):
        return Dense(self.data[_index(rows, self.data.device)])

    def permute(self, perm, mode=None):
        from .permutation import _invert_perm, permute_mode
        perm = _index(perm, self.data.device)
        mode = permute_mode.symmetric if mode is None else mode
        # forward rows: A'(i,:) = A(p[i],:) = d[perm]; the inverse flag
        # swaps in p⁻¹ (same convention as permute_data / Csr.permute)
        idx = _invert_perm(perm) if (mode & permute_mode.inverse) else perm
        d = self.data
        if mode & permute_mode.rows:
            d = d[idx]
        if mode & permute_mode.columns:
            d = d[:, idx]
        return Dense(d)

    def scale_permute(self, row_sp, mode=None, col_sp=None,
                      invert: bool = False):
        """Scaled permutation (``dense.hpp:505-560``): one ScaledPermutation
        + permute_mode, or a row/col pair with ``invert``.  Direct tensor
        ops (no triplet round-trip), so explicit zeros/NaNs pass through."""
        from .permutation import _invert_perm, _normalize_scale_permute
        (rp, rs), (cp, cs), do_rows, do_cols, inv_flag = \
            _normalize_scale_permute(row_sp, mode, col_sp, invert)
        d = self.data
        dev = d.device
        if do_rows:
            rs_ = torch.as_tensor(rs, device=dev).to(d.dtype)
            if inv_flag:
                # A' = S⁻¹A: A'(p[j], :) = A(j, :)/s[j]
                d = (d / rs_[:, None])[_index(_invert_perm(rp), dev)]
            else:
                # A'(i, :) = s[i] A(p[i], :)
                d = rs_[:, None] * d[_index(rp, dev)]
        if do_cols:
            cs_ = torch.as_tensor(cs, device=dev).to(d.dtype)
            if inv_flag:
                # A' = A S⁻ᵀ: A'(:, p[k]) = A(:, k)/s[k]
                d = (d / cs_[None, :])[:, _index(_invert_perm(cp), dev)]
            else:
                # A' = A Sᵀ: A'(:, j) = A(:, p[j]) s[j]
                d = d[:, _index(cp, dev)] * cs_[None, :]
        return Dense(d)

    def create_submatrix(self, rows: slice, cols: slice):
        return Dense(self.data[rows, cols])

    def to_matrix_data(self) -> MatrixData:
        from .csr import _values_numpy
        return MatrixData.from_dense(_values_numpy(self.data))


def _index(idx, device):
    """An index array or tensor as an int64 tensor on ``device``."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def _data_of(other):
    return other.data if isinstance(other, Dense) else torch.as_tensor(other)


def _acc_dtype(dtype):
    """Accumulate bf16/f16 matmuls in f32."""
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


# ---------------------------------------------------------------------------
# Multivector BLAS-1 (columnwise), mirroring dense.hpp's op list.
# ---------------------------------------------------------------------------

def compute_dot(a, b):
    """Columnwise non-conjugated dot: (k,) for (n,k) inputs."""
    return torch.sum(a * b, dim=0)


def compute_conj_dot(a, b):
    return torch.sum(torch.conj(a) * b, dim=0)


def compute_norm2(a):
    return torch.sqrt(torch.real(compute_conj_dot(a, a)))


def compute_norm1(a):
    return torch.sum(torch.abs(a), dim=0)


def compute_mean(a):
    return torch.mean(a, dim=0)


def compute_squared_norm2(a):
    """Columnwise squared 2-norm (``dense.hpp:1088`` compute_squared_norm2)."""
    return torch.real(compute_conj_dot(a, a))


def scale(alpha, a):
    return alpha * a


def inv_scale(alpha, a):
    return a / alpha


def add_scaled(alpha, x, y):
    """y + alpha*x (Ginkgo's add_scaled mutates y; we return)."""
    return y + alpha * x


def sub_scaled(alpha, x, y):
    return y - alpha * x
