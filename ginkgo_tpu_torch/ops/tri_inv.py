"""Batched lower-triangular inverse (recursive doubling)
(``ginkgo_tpu/ops/tri_inv.py`` in torch).

The block-partitioned trisolves (``ops/tri_banded.py``,
``ops/tri_packed.py``) need inverses of (nb, S, S) lower-triangular
diagonal blocks at generate time.  The whole stack inverts with batched
matrix products via Schur doubling:

    inv [[A, 0], [B, C]] = [[A^-1, 0], [-C^-1 B A^-1, C^-1]]

Level m holds the inverses of all diagonal (m, m) sub-blocks as one
(nb*S/m, m, m) stack; each doubling assembles 2m-blocks from two batched
(m, m) products.  log2(S) levels, ~S^3/3 flops per block.

The products are plain ``torch.matmul`` (the JAX package leaves them to
XLA, outside any Pallas kernel, at ``Precision.HIGHEST``).  They run in
full f32 whatever the caller set: ``_full_f32_matmul`` turns TF32 off for
cuBLAS around them and puts the caller's setting back afterwards.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _full_f32_matmul():
    """cuBLAS f32 products without TF32 inside the block; the caller's
    ``torch.backends.cuda.matmul.fp32_precision`` is restored on exit
    (``torch.set_float32_matmul_precision`` and ``allow_tf32`` set the
    same flag)."""
    flags = torch.backends.cuda.matmul
    prev = flags.fp32_precision
    flags.fp32_precision = "ieee"
    try:
        yield
    finally:
        flags.fp32_precision = prev


def batched_lowtri_inverse(Lb, unit_diagonal=False):
    """Inverse of each lower-triangular block of ``Lb`` (nb, S, S);
    S must be a power of two.  Zero/missing diagonals invert as 1
    (matching the host planner's singular-diagonal guard)."""
    with _full_f32_matmul():
        return _doubling_inverse(Lb, unit_diagonal)


def _doubling_inverse(Lb, unit_diagonal):
    nb, S, S2 = Lb.shape
    assert S == S2 and S & (S - 1) == 0, Lb.shape
    dt, dev = Lb.dtype, Lb.device
    diag = (torch.ones((nb, S), dtype=dt, device=dev) if unit_diagonal
            else torch.diagonal(Lb, dim1=1, dim2=2))
    diag = torch.where(diag == 0, torch.ones((), dtype=dt, device=dev), diag)
    # level m=1: (nb*S, 1, 1) reciprocal stack
    inv = (1.0 / diag).reshape(nb * S, 1, 1)
    Lflat = Lb.reshape(nb, S * S)
    m = 1
    while m < S:
        two = 2 * m
        k = S // two                     # 2m-blocks per row block
        # B sub-blocks: rows [m:2m), cols [0:m) of every diagonal
        # (2m, 2m) block, one flat gather with static per-level indices
        r0 = (torch.arange(k, device=dev) * two)[:, None, None]
        ii = torch.arange(m, device=dev)[None, :, None]
        jj = torch.arange(m, device=dev)[None, None, :]
        idx = ((r0 + m + ii) * S + (r0 + jj)).reshape(-1)
        B = Lflat[:, idx].reshape(nb * k, m, m)
        A_inv = inv[0::2]
        C_inv = inv[1::2]
        ll = -torch.matmul(torch.matmul(C_inv, B), A_inv)
        new = torch.zeros((nb * k, two, two), dtype=dt, device=dev)
        new[:, :m, :m] = A_inv
        new[:, m:, m:] = C_inv
        new[:, m:, :m] = ll
        inv = new
        m = two
    return inv.reshape(nb, S, S)
