"""The distributed SpMV on the banded (kernel A) and packed (kernel B)
local layouts: the port against ginkgo_tpu on the same numpy inputs, on
the CPU, in f64 and complex128, each to 1e-12 relative; the neighborhood
communicator bit for bit the dense one; the port over the reference's own
planned arrays (``interop.distributed_from_arrays``) bit for bit the
port's.  The gather layout is in ``test_torch_distributed.py``."""

import pytest

from test_torch_distributed import spmv_case


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("layout", ["banded", "packed"])
def test_spmv_matches_reference(layout, dtype):
    spmv_case(layout, dtype)
