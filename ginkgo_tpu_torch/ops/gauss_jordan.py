"""Batched small-dense inversion and solve
(``ginkgo_tpu/ops/gauss_jordan.py`` in torch).

The reference's block-Jacobi inversion is a hand-written Gauss-Jordan
device kernel
(``common/cuda_hip/preconditioner/jacobi_generate_kernels.instantiate.cpp``
``invert_block``).  The JAX package takes LU (``jnp.linalg.solve``) where
the TPU's LU call exists (f32, c64) and its partial-pivoted Gauss-Jordan
in jnp ops elsewhere (f64, c128 on the TPU).  Here the routes are by
dtype, on the CPU and CUDA alike:

* float32, float64, complex64, complex128: LU through
  ``torch.linalg.solve_ex`` (cuSOLVER/cuBLAS batched on CUDA; it checks
  no pivot on the host, so a singular block gives inf/nan, as the JAX
  package's LU does, and costs no sync);
* any other dtype (bfloat16, float16, which LU does not take):
  ``_gauss_jordan_inverse_single``, batched over the leading axes.

Gauss-Jordan replaces a zero pivot by 1, so a structurally singular
block degrades as scalar Jacobi's ``1/0 -> 1`` does.
"""

from __future__ import annotations

import torch

_LU_DTYPES = (torch.float32, torch.float64, torch.complex64,
              torch.complex128)


def _gauss_jordan_inverse_single(blk):
    """(..., bs, bs) -> inverses by partial-pivoted Gauss-Jordan on the
    augmented ``[blk | I]``, every leading index at once."""
    bs = blk.shape[-1]
    eye = torch.eye(bs, dtype=blk.dtype, device=blk.device)
    aug = torch.cat([blk, eye.expand(blk.shape)], dim=-1)   # (..., bs, 2bs)
    rows = torch.arange(bs, device=blk.device)
    for k in range(bs):
        col = aug[..., :, k].abs()
        col = torch.where(rows >= k, col, torch.full((), -float("inf"),
                                                     dtype=col.dtype,
                                                     device=col.device))
        p = col.argmax(dim=-1)                        # first maximum
        pidx = p[..., None, None].expand(*p.shape, 1, 2 * bs)
        rk = aug[..., k:k + 1, :].clone()
        aug[..., k:k + 1, :] = torch.gather(aug, -2, pidx)
        aug.scatter_(-2, pidx, rk)                    # partial pivot swap
        piv = aug[..., k, k]
        piv = torch.where(piv == 0, torch.ones_like(piv), piv)
        rowk = aug[..., k, :] / piv[..., None]
        aug[..., k, :] = rowk
        factors = aug[..., :, k].clone()
        factors[..., k] = 0
        aug = aug - factors[..., :, None] * rowk[..., None, :]
    return aug[..., :, bs:]


def batched_inverse(blocks):
    """(nb, bs, bs) -> (nb, bs, bs) inverses (the route by dtype above)."""
    if blocks.dtype not in _LU_DTYPES:
        return _gauss_jordan_inverse_single(blocks)
    bs = blocks.shape[-1]
    eye = torch.eye(bs, dtype=blocks.dtype, device=blocks.device)
    return torch.linalg.solve_ex(blocks, eye.expand(blocks.shape))[0]


def batched_solve(mats, rhs):
    """Batched dense solve A_i x_i = b_i: ``rhs`` (nb, bs) or (nb, bs, k)."""
    if mats.dtype not in _LU_DTYPES:
        inv = _gauss_jordan_inverse_single(mats)
        if rhs.ndim == mats.ndim:                       # matrix RHS
            return torch.einsum("bij,bjk->bik", inv, rhs)
        return torch.einsum("bij,bj->bi", inv, rhs)
    if rhs.ndim == mats.ndim:
        return torch.linalg.solve_ex(mats, rhs)[0]
    return torch.linalg.solve_ex(mats, rhs[..., None])[0][..., 0]


def dense_solve(mat, rhs):
    """Single dense solve A x = b (``rhs`` a vector or a matrix)."""
    if mat.dtype not in _LU_DTYPES:
        return _gauss_jordan_inverse_single(mat) @ rhs
    if rhs.ndim == 1:
        return torch.linalg.solve_ex(mat, rhs[:, None])[0][:, 0]
    return torch.linalg.solve_ex(mat, rhs)[0]
