"""The operator protocol (``ginkgo_tpu/base/linop.py`` in torch).

Ginkgo unifies matrix / preconditioner / solver behind one abstraction with
two applies (``include/ginkgo/core/base/lin_op.hpp:117``):
``apply(b, x)`` and ``apply(alpha, b, beta, x)``.  Here operators are plain
classes holding tensors; ``apply`` is functional: it *returns* the result
instead of mutating ``x``.
"""

from __future__ import annotations

import copy

import torch

from ..device import resolve_device


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
        if isinstance(b, LinOp):
            from .composition import Composition
            return Composition((self, b))
        return self.apply(b)

    @property
    def dtype(self) -> torch.dtype:
        """The value type: that of the first floating or complex tensor
        the operator holds (float32 when it holds none)."""
        for leaf in tensor_leaves(self):
            if leaf.is_floating_point() or leaf.is_complex():
                return leaf.dtype
        return torch.float32

    @property
    def device(self) -> torch.device:
        """The device of the first tensor the operator holds; one that
        holds none (``Identity``) is on the entry points' default device,
        the card (``device.resolve_device``)."""
        for leaf in tensor_leaves(self):
            return leaf.device
        return resolve_device(None)

    def to_dense(self):
        """Materialise as a dense (n, m) tensor by applying to identity —
        the generic fallback; formats override with direct scatters."""
        n, m = self.shape
        return self._apply(torch.eye(m, dtype=self.dtype,
                                     device=self.device))


def _children(obj):
    if isinstance(obj, LinOp):
        return list(vars(obj).values())
    if isinstance(obj, dict):
        return list(obj.values())
    if isinstance(obj, (tuple, list)):
        return list(obj)
    return []


def tensor_leaves(obj):
    """The tensors an operator holds, depth first in attribute order
    (through nested operators, tuples, lists and dicts)."""
    if isinstance(obj, torch.Tensor):
        yield obj
        return
    for child in _children(obj):
        yield from tensor_leaves(child)


def map_tensors(obj, fn):
    """A copy of ``obj`` with ``fn`` applied to every tensor it holds;
    operators are copied shallowly, nothing is modified in place."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, LinOp):
        new = copy.copy(obj)
        for name, value in vars(obj).items():
            setattr(new, name, map_tensors(value, fn))
        return new
    if isinstance(obj, dict):
        return {key: map_tensors(value, fn) for key, value in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(value, fn) for value in obj)
    return obj


def absolute_of_storage(op):
    """|A| entrywise for a *storage* format (AbsoluteComputable mixin): abs
    over every floating or complex tensor; index/pattern tensors pass
    through.  Only valid when the operator's value tensors ARE its entries
    — storage formats opt in by defining ``compute_absolute`` in terms of
    this helper; composite/solver operators deliberately do not
    (|A·B| != |A|·|B|)."""
    return map_tensors(op, lambda x: torch.abs(x)
                       if x.is_floating_point() or x.is_complex() else x)


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
