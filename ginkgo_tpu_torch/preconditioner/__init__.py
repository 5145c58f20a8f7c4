"""Preconditioners (core/preconditioner analogs); scalar Jacobi so far."""

from .jacobi import Jacobi  # noqa: F401
