"""Multigrid components (``ginkgo_tpu/multigrid`` in torch; core/multigrid
analogs), ``DistributedPgm`` for the distributed tier among them."""

from .pgm import (AggProlong, AggRestrict, FixedCoarsening,  # noqa: F401
                  MultigridLevel, Pgm)
from .distributed_pgm import DistributedPgm  # noqa: F401
