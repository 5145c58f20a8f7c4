"""Incomplete factorizations (core/factorization analogs): ParILU/ParIC
and the exact ILU(0)/IC(0) so far."""

from .container import Factorization  # noqa: F401
from .par_ilu import Ic0, Ilu0, ParIc, ParIlu  # noqa: F401
