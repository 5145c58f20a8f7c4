"""Kernel layer: backend registry + reference (plain torch) and CUDA tiers.

Importing this package registers every kernel; the CUDA libraries are
compiled only when a CUDA tensor first reaches their wrapper.
"""

from . import spmv  # noqa: F401  (registers reference kernels)
from . import spmv_banded  # noqa: F401  (registers the banded tiers)
from . import spmv_packed  # noqa: F401  (registers the packed tiers)
from . import tri_banded  # noqa: F401  (registers the banded trisolve)
from . import tri_packed  # noqa: F401  (registers the packed trisolve tiers)
from . import pair_contract  # noqa: F401  (registers the pair contraction)
from . import row_write  # noqa: F401  (registers the Krylov-basis row write)
from .registry import lookup, register, use_tier, current_tier  # noqa: F401
