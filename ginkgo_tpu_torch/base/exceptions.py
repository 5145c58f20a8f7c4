"""Typed exception hierarchy (``include/ginkgo/core/base/exception.hpp``).

Each type subclasses the builtin it previously surfaced as (ValueError /
IndexError), so ``except ValueError`` call sites keep working while users
coming from the reference can catch the specific condition
(``DimensionMismatch``, ``UnsupportedMatrixProperty``, ...).
"""

from __future__ import annotations


class GinkgoError(Exception):
    """Root of the typed hierarchy (``gko::Error``)."""


class DimensionMismatch(GinkgoError, ValueError):
    """Operator/vector dimensions do not conform
    (``GKO_ASSERT_CONFORMANT`` / ``gko::DimensionMismatch``)."""


class BadDimension(GinkgoError, ValueError):
    """A dimension has an invalid value (``gko::BadDimension``)."""


class ValueMismatch(GinkgoError, ValueError):
    """Two values that must agree do not (``gko::ValueMismatch``)."""


class UnsupportedMatrixProperty(GinkgoError, ValueError):
    """The matrix lacks a property the operation requires, e.g. a
    structurally full diagonal (``gko::UnsupportedMatrixProperty``)."""


class NotSupportedError(GinkgoError, ValueError):
    """The requested configuration/type is not supported
    (``gko::NotSupported``)."""


class OutOfBoundsError(GinkgoError, IndexError, ValueError):
    """An index lies outside the valid range (``gko::OutOfBoundsError``).
    Subclasses ValueError as well: the sites that now raise it previously
    raised ValueError, and ``except ValueError`` handlers must keep
    working."""
