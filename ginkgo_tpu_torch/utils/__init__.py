"""Utilities: matrix generators."""

from . import generators  # noqa: F401
