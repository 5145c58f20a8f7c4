"""The operator protocol (``ginkgo_tpu/base/linop.py`` in torch).

Ginkgo unifies matrix / preconditioner / solver behind one abstraction with
two applies (``include/ginkgo/core/base/lin_op.hpp:117``):
``apply(b, x)`` and ``apply(alpha, b, beta, x)``.  Here operators are plain
classes holding tensors; ``apply`` is functional: it *returns* the result
instead of mutating ``x``.
"""

from __future__ import annotations

import torch


class LinOp:
    """Duck-typed operator protocol. Subclasses have a ``shape`` and
    implement ``_apply(b)`` on 2-D multivectors."""

    shape: tuple[int, int]

    def apply(self, b):
        """x = Op @ b.  ``b``: (n,) or (n, k); result has matching rank."""
        b2, squeeze = as_multivector(b)
        check_apply_dims(self.shape, b2)
        logging = _log_hook(self, "started")
        out = self._apply(b2)
        if logging:
            _log_hook(self, "completed")
        return out[:, 0] if squeeze else out

    def apply_advanced(self, alpha, b, beta, x):
        """x' = alpha * Op @ b + beta * x  (Ginkgo's 4-arg apply)."""
        b2, squeeze = as_multivector(b)
        x2, _ = as_multivector(x)
        check_apply_dims(self.shape, b2, x2)
        out = self._apply_advanced(alpha, b2, beta, x2)
        return out[:, 0] if squeeze else out

    def _apply(self, b):
        raise NotImplementedError

    def _apply_advanced(self, alpha, b, beta, x):
        return alpha * self._apply(b) + beta * x

    def __matmul__(self, b):
        return self.apply(b)


def _log_hook(op, phase: str) -> bool:
    """Fire linop_apply_* on the logger bus."""
    from ..log import logger as _log
    if not _log.has_loggers():
        return False
    _log.dispatch(f"linop_apply_{phase}", op_id=id(op),
                  op_type=type(op).__name__)
    return True


def as_multivector(b):
    """Canonicalise a vector/multivector to 2-D (n, k); returns (b2, squeeze)."""
    b = torch.as_tensor(b)
    if b.ndim == 1:
        return b[:, None], True
    if b.ndim == 2:
        return b, False
    from .exceptions import BadDimension
    raise BadDimension(
        f"expected rank-1/2 multivector, got shape {tuple(b.shape)}")


def check_apply_dims(op_shape, b, x=None):
    """Ginkgo's GKO_ASSERT_CONFORMANT analog."""
    from .exceptions import DimensionMismatch
    n, m = op_shape
    if b.shape[0] != m:
        raise DimensionMismatch(
            f"dimension mismatch: op {op_shape} @ b {tuple(b.shape)}")
    if x is not None and x.shape[0] != n:
        raise DimensionMismatch(
            f"dimension mismatch: op {op_shape} -> x {tuple(x.shape)}")
