"""Benchmark infrastructure: the generated test cases so far."""

from .runner import build_matrix_data  # noqa: F401
