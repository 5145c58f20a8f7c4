"""Preconditioners (core/preconditioner analogs): scalar Jacobi, ILU and
IC."""

from .ilu import Ic, Ilu, IluApply  # noqa: F401
from .jacobi import Jacobi  # noqa: F401
