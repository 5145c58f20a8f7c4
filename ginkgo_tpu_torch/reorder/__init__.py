"""Reorderings (core/reorder analogs): RCM, AMD, MC64, nested dissection,
ScaledReordered wrapper (``ginkgo_tpu/reorder`` in torch)."""

from .rcm import Rcm, rcm_ordering  # noqa: F401
from .amd import Amd, amd_ordering  # noqa: F401
from .mc64 import Mc64, mc64_matching  # noqa: F401
from .nested_dissection import NestedDissection  # noqa: F401
from .scaled_reordered import ScaledReordered  # noqa: F401
