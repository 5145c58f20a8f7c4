"""Utilities: generators, timers, checkpointing, sparse interop."""

from . import generators  # noqa: F401
from .timer import CpuTimer, DeviceTimer, topology  # noqa: F401
from . import checkpoint  # noqa: F401
from .interop import (from_scipy, to_scipy, from_sparse_coo,  # noqa: F401
                      to_sparse_coo, from_sparse_csr, to_sparse_csr)
