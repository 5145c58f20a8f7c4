"""ginkgo_tpu_torch — the PyTorch/CUDA port of ``ginkgo_tpu``.

The same public names and semantics as the JAX package, on PyTorch
tensors.  Plain tensor code is PyTorch; each Pallas kernel of the JAX
package becomes a kernel written by hand for Hopper (``ops/csrc/``),
compiled by ``nvcc`` at first use.  Entry points place their tensors on the
CUDA device unless the caller passes ``device="cpu"``.  The package imports
neither ``jax`` nor ``ginkgo_tpu``.
"""

from .base.exceptions import (GinkgoError, DimensionMismatch, BadDimension,
                              ValueMismatch, UnsupportedMatrixProperty,
                              NotSupportedError, OutOfBoundsError)
from .base.matrix_data import MatrixData
from .base.mtx_io import read_mtx, write_mtx, read_binary, write_binary
from .base.linop import LinOp
from .base.composition import (Composition, Combination, Perturbation,
                               BlockOperator)
from .base.precision import (precision_dispatch,
                             precision_dispatch_real_complex, version_info)
from .matrix.dense import Dense
from .matrix.csr import Csr
from .matrix.coo import Coo
from .matrix.ell import Ell
from .matrix.sellp import Sellp
from .matrix.hybrid import Hybrid
from .matrix.fbcsr import Fbcsr
from .matrix.sparsity_csr import SparsityCsr
from .matrix.diagonal import Diagonal
from .matrix.identity import Identity
from .matrix.permutation import Permutation, ScaledPermutation, permute_mode
from .matrix.row_gatherer import RowGatherer
from .matrix.fft import Fft, Fft2, Fft3, FftNd
from .device import resolve_device

__version__ = "0.1.0"

# umbrella namespaces (include/ginkgo/ginkgo.hpp analog) — imported lazily
# to keep `import ginkgo_tpu_torch` light; `gtt.solver.Cg` etc. work on
# first touch.
_SUBMODULES = ("solver", "preconditioner", "factorization", "multigrid",
               "reorder", "distributed", "batch", "config", "log", "stop",
               "utils", "benchmark")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
