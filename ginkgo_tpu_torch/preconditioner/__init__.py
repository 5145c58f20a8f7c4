"""Preconditioners (core/preconditioner analogs): scalar and block Jacobi,
ILU and IC, ISAI, SOR and Gauss-Seidel."""

from .ilu import Ic, Ilu, IluApply  # noqa: F401
from .isai import Isai  # noqa: F401
from .jacobi import Jacobi  # noqa: F401
from .sor import GaussSeidel, Sor  # noqa: F401
