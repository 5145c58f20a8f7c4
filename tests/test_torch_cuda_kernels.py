"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one.  They import neither
JAX nor ``ginkgo_tpu``, so on a machine without JAX run them past the
repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

import ginkgo_tpu_torch as gtt
from ginkgo_tpu_torch.ops import registry, spmv_banded, spmv_packed
from ginkgo_tpu_torch.preconditioner import Jacobi
from ginkgo_tpu_torch.solver import Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import permute_locally, stencil_3d

pytestmark = pytest.mark.cuda

# f32 sums in another order (the kernel fuses multiply-adds); bf16/f16
# storage is widened to f32 on both sides
TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-5,
       torch.float16: 1e-5}
VDTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.float16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _xdtype(vdtype):
    return torch.float64 if vdtype == torch.float64 else torch.float32


def _rel_err(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-300)


def _banded(n, offsets, dev, vdtype):
    g = np.random.default_rng(n)
    dv = g.standard_normal((len(offsets), n))
    for d, off in enumerate(offsets):
        if off < 0:
            dv[d, :-off] = 0
        elif off > 0:
            dv[d, n - off:] = 0
    meta = spmv_banded.plan_banded_layout(tuple(offsets), n)
    dvb = torch.from_numpy(spmv_banded.block_diag_values(dv, meta))
    return meta, dvb.to(device=dev, dtype=vdtype)


@pytest.mark.parametrize("vdtype", VDTYPES, ids=str)
@pytest.mark.parametrize("k", [1, 3, 8, 9])
def test_dia_kernel_matches_plain(dev, vdtype, k):
    n, offsets = 3000, (-257, -129, -1, 0, 1, 129, 257)
    meta, dvb = _banded(n, offsets, dev, vdtype)
    x = torch.randn((n, k), dtype=_xdtype(vdtype), device=dev)
    before = spmv_banded.dia_spmv_cuda.launches
    y = spmv_banded.dia_spmv_cuda(offsets, dvb, meta, x)
    torch.cuda.synchronize()
    assert spmv_banded.dia_spmv_cuda.launches - before == -(-k // 8)
    want = spmv_banded.dia_spmv_reference(offsets, dvb, meta, x)
    assert _rel_err(y, want) <= TOL[vdtype]


def _packed_csr(dev):
    return gtt.Csr.from_data(permute_locally(stencil_3d(16, 16, 8,
                                                        points=27)),
                             device=dev)


@pytest.mark.parametrize("vdtype", VDTYPES, ids=str)
@pytest.mark.parametrize("k", [1, 3, 8, 9])
def test_pell_kernel_matches_plain(dev, vdtype, k):
    A = _packed_csr(dev)
    assert A.strategy == "packed"
    args = (A.pell_vals.to(vdtype), A.pell_idx, A.pell_qw, A.pell_xbase,
            A.pell_meta)
    x = torch.randn((A.shape[1], k), dtype=_xdtype(vdtype), device=dev)
    before = spmv_packed.pell_spmv_cuda.launches
    y = spmv_packed.pell_spmv_cuda(*args, x)
    torch.cuda.synchronize()
    assert spmv_packed.pell_spmv_cuda.launches - before == -(-k // 8)
    want = spmv_packed.pell_spmv_reference(*args, x)
    assert _rel_err(y, want) <= TOL[vdtype]


def test_wrappers_raise_instead_of_falling_back(dev):
    n, offsets = 1000, (-1, 0, 1)
    meta, dvb = _banded(n, offsets, dev, torch.float32)
    x = torch.randn((n, 2), dtype=torch.float32, device=dev)
    with pytest.raises(TypeError):
        spmv_banded.dia_spmv_cuda(offsets, dvb, meta, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        spmv_banded.dia_spmv_cuda(offsets, dvb, meta, x.t().contiguous().t())
    with pytest.raises(NotImplementedError, match="re/im"):
        spmv_banded.dia_spmv_cuda(offsets, dvb.to(torch.complex64), meta,
                                  x.to(torch.complex64))
    A = _packed_csr(dev)
    xb = torch.ones((A.shape[1], 1), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        spmv_packed.pell_spmv_cuda(A.pell_vals.float(), A.pell_idx, A.pell_qw,
                                   A.pell_xbase, A.pell_meta, xb)
    with pytest.raises(NotImplementedError, match="re/im"):
        spmv_packed.pell_spmv_cuda(A.pell_vals.to(torch.complex128),
                                   A.pell_idx, A.pell_qw, A.pell_xbase,
                                   A.pell_meta, xb.to(torch.complex128))
    assert registry.lookup("dia_spmv", dev) is spmv_banded.dia_spmv_cuda


@pytest.mark.parametrize("make", [lambda: stencil_3d(12, points=27),
                                  lambda: permute_locally(
                                      stencil_3d(16, 16, 8, points=27))])
def test_cg_on_card_matches_host(dev, make):
    data = make()
    b = np.random.default_rng(1).standard_normal((data.shape[0], 3))
    crit = Iteration(500) | ResidualNorm(1e-10)
    A = gtt.Csr.from_data(data)            # the default device: the card
    assert A.device.type == "cuda"
    rg = Cg.solve(A, torch.from_numpy(b).to(dev), criteria=crit,
                  preconditioner=Jacobi())
    Ac = gtt.Csr.from_data(data, device="cpu")
    rc = Cg.solve(Ac, torch.from_numpy(b), criteria=crit,
                  preconditioner=Jacobi())
    assert torch.equal(rg.iterations.cpu(), rc.iterations)
    assert torch.equal(rg.converged.cpu(), rc.converged)
    torch.testing.assert_close(rg.x.cpu(), rc.x, rtol=1e-9, atol=1e-9)
