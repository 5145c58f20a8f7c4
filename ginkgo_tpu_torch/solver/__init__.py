"""Krylov and relaxation solvers (``core/solver/`` analogs): CG, FCG,
pipelined CG, BiCG, BiCGSTAB, CGS, MINRES, GMRES and CB-GMRES, GCR, IDR,
IR/Richardson and Chebyshev, the triangular solves and the direct
solver."""

from .common import SolveResult, SolverOp  # noqa: F401
from .bicg import Bicg  # noqa: F401
from .bicgstab import Bicgstab  # noqa: F401
from .cg import Cg  # noqa: F401
from .cgs import Cgs  # noqa: F401
from .chebyshev import Chebyshev  # noqa: F401
from .fcg import Fcg  # noqa: F401
from .gcr import Gcr  # noqa: F401
from .gmres import CbGmres, Gmres  # noqa: F401
from .idr import Idr  # noqa: F401
from .ir import Ir, Richardson  # noqa: F401
from .minres import Minres  # noqa: F401
from .pipe_cg import PipeCg  # noqa: F401
from .triangular import LowerTrs, UpperTrs  # noqa: F401
from .direct import Direct  # noqa: F401
