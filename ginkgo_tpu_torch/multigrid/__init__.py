"""Multigrid components (``ginkgo_tpu/multigrid`` in torch; core/multigrid
analogs).  ``DistributedPgm`` joins with the distributed tier."""

from .pgm import (AggProlong, AggRestrict, FixedCoarsening,  # noqa: F401
                  MultigridLevel, Pgm)
