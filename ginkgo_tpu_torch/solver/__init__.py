"""Krylov solvers (``core/solver/`` analogs): CG, BiCGSTAB, GMRES and
CB-GMRES, and the triangular solves."""

from .common import SolveResult, SolverOp  # noqa: F401
from .bicgstab import Bicgstab  # noqa: F401
from .cg import Cg  # noqa: F401
from .gmres import CbGmres, Gmres  # noqa: F401
from .triangular import LowerTrs, UpperTrs  # noqa: F401
