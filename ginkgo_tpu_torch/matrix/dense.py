"""Multivector BLAS-1 (``ginkgo_tpu/matrix/dense.py:181-221`` in torch).

Free functions over (n, k) tensors, columnwise, mirroring ``dense.hpp``'s
op list; solvers use them with per-column stopping masks.
"""

from __future__ import annotations

import torch


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
