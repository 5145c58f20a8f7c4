"""Incomplete factorizations (core/factorization analogs): ParILU/ParIC,
the exact ILU(0)/IC(0), and the threshold ParILUT/ParICT."""

from .container import Factorization  # noqa: F401
from .par_ilu import Ic0, Ilu0, ParIc, ParIlu  # noqa: F401
from .par_ilut import ParIct, ParIlut  # noqa: F401
