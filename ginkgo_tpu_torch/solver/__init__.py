"""Krylov solvers (``core/solver/`` analogs); CG only so far."""

from .common import SolveResult, SolverOp  # noqa: F401
from .cg import Cg  # noqa: F401
