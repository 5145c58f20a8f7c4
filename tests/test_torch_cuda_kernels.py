"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one.  They import neither
JAX nor ``ginkgo_tpu``, so on a machine without JAX run them past the
repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import contextlib

import numpy as np
import pytest
import torch

import ginkgo_tpu_torch as gtt
import pair_walk
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.factorization import ParIct, ParIlu, ParIlut
from ginkgo_tpu_torch.ops import (pair_contract, registry, row_write,
                                  spmv_banded, spmv_packed, spmv_sell,
                                  tri_inv, tri_packed)
from ginkgo_tpu_torch.ops.attic import spmv_chunked, spmv_windowed
from ginkgo_tpu_torch.preconditioner import Ilu, Jacobi
from ginkgo_tpu_torch.solver import Bicgstab, CbGmres, Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import (permute_locally,
                                               random_banded,
                                               random_lower_factor, stencil_3d,
                                               symmetric_part)

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
    wide = (torch.complex128 if got.is_complex() or want.is_complex()
            else torch.float64)
    got, want = got.to(wide), want.to(wide)
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


def _chunked_stream(dev, vdtype):
    """The chunk-ELL slab of the FEM matrix and its compact stream, with
    the planned values in ``vdtype``."""
    d = build_matrix_data({"fem": 4096, "offscale": 1.2})
    layout, _, _ = spmv_chunked.plan_chunked_layout(d, d.values)
    arrays = [torch.from_numpy(layout[key]).to(dev)
              for key in spmv_chunked.ARRAYS]
    arrays[0] = arrays[0].to(vdtype)
    return (spmv_sell.sell_from_chunked(*arrays, layout["meta"]),
            (spmv_chunked.cell_spmv_reference, arrays, layout["meta"]))


def _packed_stream(dev, vdtype):
    """The packed slab of a permuted stencil and its compact stream, with
    the planned values in ``vdtype``."""
    A = _packed_csr(dev)
    assert A.strategy == "packed" and A.pell_vals.device.type == "cpu"
    arrays = [t.to(dev) for t in (A.pell_vals, A.pell_idx, A.pell_qw,
                                  A.pell_xbase)]
    arrays[0] = arrays[0].to(vdtype)
    return (spmv_sell.sell_from_packed(*arrays, A.pell_meta),
            (spmv_packed.pell_spmv_reference, arrays, A.pell_meta))


@pytest.mark.parametrize("vdtype", VDTYPES, ids=str)
@pytest.mark.parametrize("k", [1, 3, 8, 9])
@pytest.mark.parametrize("layout", ["packed", "chunked"])
def test_sell_kernel_matches_plain(dev, layout, k, vdtype):
    """``sell_spmv.cu`` (through kernel B's wrapper, which takes all four
    type pairs) over either slab's stream, against the stream's plain
    version and the slab's own."""
    make = _packed_stream if layout == "packed" else _chunked_stream
    (sell, smeta), (slab_plain, arrays, meta) = make(dev, vdtype)
    x = torch.randn((dict(smeta)["m"], k), dtype=_xdtype(vdtype), device=dev)
    before = spmv_packed.pell_spmv_cuda.launches
    y = spmv_packed.pell_spmv_cuda(sell, smeta, x)
    torch.cuda.synchronize()
    assert spmv_packed.pell_spmv_cuda.launches - before == -(-k // 8)
    assert y.dtype == x.dtype and y.shape == (dict(smeta)["n"], k)
    assert _rel_err(y, spmv_sell.sell_spmv_reference(sell, smeta, x)) \
        <= TOL[vdtype]
    assert _rel_err(y, slab_plain(*arrays, meta, x)) <= TOL[vdtype]


# (values, vector) pairs of the complex instantiations of kernels A and B
COMPLEX_PAIRS = [(torch.complex64, torch.complex64),
                 (torch.float32, torch.complex64),
                 (torch.bfloat16, torch.complex64),
                 (torch.float16, torch.complex64),
                 (torch.complex64, torch.float32),
                 (torch.complex128, torch.complex128)]


def _complex_values(t, vdtype, seed):
    """Real values made complex with an imaginary part of the same size
    (a third of them purely imaginary), in ``vdtype``."""
    if not vdtype.is_complex:
        return t.to(vdtype)
    g = torch.Generator(device="cpu").manual_seed(seed)
    im = torch.randn(t.shape, generator=g, dtype=torch.float64).to(t.device)
    re = t.double() * (torch.arange(t.numel(), device=t.device)
                       .reshape(t.shape) % 3 != 0)
    return torch.complex(re, im * (t != 0)).to(vdtype)


def _complex_tol(vdtype, xdtype):
    return 1e-12 if torch.complex128 in (vdtype, xdtype) else 1e-5


def _result_dtype(xdtype):
    """A real f32 vector is cast to complex64 first."""
    return torch.complex64 if xdtype == torch.float32 else xdtype


@pytest.mark.parametrize("vdtype,xdtype", COMPLEX_PAIRS, ids=str)
@pytest.mark.parametrize("k", [1, 3, 8, 9])
def test_dia_complex_kernel_matches_plain(dev, vdtype, xdtype, k):
    n, offsets = 3000, (-257, -129, -1, 0, 1, 129, 257)
    meta, dvb = _banded(n, offsets, dev, torch.float64)
    dvb = _complex_values(dvb, vdtype, k)
    x = torch.randn((n, k), dtype=torch.complex128, device=dev)
    x = (x.real if not xdtype.is_complex else x).to(xdtype)
    before = (spmv_banded.dia_spmv_cuda.launches,
              spmv_banded.dia_spmv_complex_cuda.launches)
    y = spmv_banded.dia_spmv_cuda(offsets, dvb, meta, x)
    torch.cuda.synchronize()
    assert spmv_banded.dia_spmv_cuda.launches == before[0]
    assert spmv_banded.dia_spmv_complex_cuda.launches - before[1] \
        == -(-k // 8)
    assert y.dtype == _result_dtype(xdtype)
    want = spmv_banded.dia_spmv_reference(offsets, dvb, meta, x.to(y.dtype))
    assert _rel_err(y, want) <= _complex_tol(vdtype, xdtype)


@pytest.mark.parametrize("vdtype,xdtype", COMPLEX_PAIRS, ids=str)
@pytest.mark.parametrize("k", [1, 3, 8, 9])
def test_sell_complex_kernel_matches_plain(dev, vdtype, xdtype, k):
    """Kernel B's complex instantiation over the compact stream of a
    complex slab (an entry whose real part is 0 kept), against the
    stream's plain version and the slab's own."""
    A = _packed_csr(dev)
    arrays = [t.to(dev) for t in (A.pell_vals, A.pell_idx, A.pell_qw,
                                  A.pell_xbase)]
    arrays[0] = _complex_values(arrays[0], vdtype, k)
    sell, smeta = spmv_sell.sell_from_packed(*arrays, A.pell_meta)
    assert dict(smeta)["entries"] == int((arrays[0] != 0).sum())
    x = torch.randn((A.shape[1], k), dtype=torch.complex128, device=dev)
    x = (x.real if not xdtype.is_complex else x).to(xdtype)
    before = spmv_packed.pell_spmv_complex_cuda.launches
    y = spmv_packed.pell_spmv_cuda(sell, smeta, x)
    torch.cuda.synchronize()
    assert spmv_packed.pell_spmv_complex_cuda.launches - before \
        == -(-k // 8)
    assert y.dtype == _result_dtype(xdtype)
    xc = x.to(y.dtype)
    tol = _complex_tol(vdtype, xdtype)
    assert _rel_err(y, spmv_sell.sell_spmv_reference(sell, smeta, xc)) <= tol
    assert _rel_err(y, spmv_packed.pell_spmv_reference(
        *arrays, A.pell_meta, xc)) <= tol


def _small_complex_system(kind, dev):
    """A few thousand rows in complex128: the shifted stencil
    A = P (1 + 0.02i) + 0.5i I, banded or permuted (packed)."""
    d = (stencil_3d(14, points=27) if kind == "banded"
         else permute_locally(stencil_3d(16, 16, 8, points=27)))
    vals = d.values * (1 + 0.02j) + 0.5j * (d.row_idx == d.col_idx)
    A = gtt.Csr.from_data(gtt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                         vals), device=dev)
    assert A.strategy == kind
    return A


@pytest.mark.parametrize("solver", ["Bicg", "Cgs", "Gcr", "Idr", "Gmres"])
@pytest.mark.parametrize("kind", ["banded", "packed"])
def test_complex_solvers_on_card_match_host(dev, kind, solver):
    """complex128 solves on the card (the complex kernels A or B, kernel F
    in 16-byte elements for Gcr and Gmres) against the host."""
    import ginkgo_tpu_torch.solver as tsolver
    out = []
    for device in (dev, torch.device("cpu")):
        A = _small_complex_system(kind, device)
        rhs = torch.ones((A.shape[0], 2), dtype=torch.complex128,
                         device=device)
        rhs[:, 1] = torch.arange(A.shape[0], device=device) % 7 - 3j
        kw = {"krylov_dim": 30} if solver in ("Gcr", "Gmres") else {}
        res = getattr(tsolver, solver).solve(
            A, rhs, criteria=Iteration(500) | ResidualNorm(1e-10), **kw)
        out.append(res)
    rg, rc = out
    assert bool(rg.converged.all())
    assert torch.equal(rg.iterations.cpu(), rc.iterations)
    torch.testing.assert_close(rg.x.cpu(), rc.x, rtol=1e-10, atol=1e-10)


def test_wrappers_raise_instead_of_falling_back(dev):
    n, offsets = 1000, (-1, 0, 1)
    meta, dvb = _banded(n, offsets, dev, torch.float32)
    x = torch.randn((n, 2), dtype=torch.float32, device=dev)
    with pytest.raises(TypeError):
        spmv_banded.dia_spmv_cuda(offsets, dvb, meta, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        spmv_banded.dia_spmv_cuda(offsets, dvb, meta, x.t().contiguous().t())
    # complex operands run the kernel's complex instantiation (no plane
    # split, no fallback); a pair it does not take still raises
    c64 = dvb.to(torch.complex64)
    xc = x.to(torch.complex64)
    before = spmv_banded.dia_spmv_complex_cuda.launches
    y = spmv_banded.dia_spmv_cuda(offsets, c64, meta, xc)
    torch.cuda.synchronize()
    assert spmv_banded.dia_spmv_complex_cuda.launches - before == 1
    assert _rel_err(y, spmv_banded.dia_spmv_reference(offsets, c64, meta,
                                                      xc)) <= 1e-5
    with pytest.raises(TypeError):
        spmv_banded.dia_spmv_cuda(offsets, c64, meta, x.double())
    A = _packed_csr(dev)
    xb = torch.ones((A.shape[1], 1), dtype=torch.float64, device=dev)
    f32 = dict(A.sell, sv=A.sell["sv"].float())
    with pytest.raises(TypeError):
        spmv_packed.pell_spmv_cuda(f32, A.sell_meta, xb)
    c128 = dict(A.sell, sv=A.sell["sv"].to(torch.complex128))
    before = spmv_packed.pell_spmv_complex_cuda.launches
    y = spmv_packed.pell_spmv_cuda(c128, A.sell_meta, xb.to(torch.complex128))
    torch.cuda.synchronize()
    assert spmv_packed.pell_spmv_complex_cuda.launches - before == 1
    assert _rel_err(y, spmv_sell.sell_spmv_reference(
        c128, A.sell_meta, xb.to(torch.complex128))) <= 1e-12
    with pytest.raises(TypeError):
        spmv_packed.pell_spmv_cuda(dict(A.sell, sv=A.sell["sv"].to(
            torch.complex64)), A.sell_meta, xb)
    with pytest.raises(ValueError, match="one device"):
        spmv_packed.pell_spmv_cuda(dict(A.sell, sp=A.sell["sp"].cpu()),
                                   A.sell_meta, xb)
    with pytest.raises(ValueError, match="contiguous"):
        spmv_packed.pell_spmv_cuda(A.sell, A.sell_meta,
                                   xb.repeat(1, 2)[:, :1])
    with pytest.raises(ValueError):
        spmv_packed.pell_spmv_cuda(A.sell, A.sell_meta, xb[:-1])
    assert registry.lookup("dia_spmv", dev) is spmv_banded.dia_spmv_cuda
    assert registry.lookup("pell_spmv", dev) is spmv_packed.pell_spmv_cuda


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


@pytest.mark.parametrize("bdtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("k", [1, 3, 8, 9])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
def test_tri_kernel_matches_plain(dev, lower, k, bdtype):
    d = random_lower_factor(1700, 7, 600, 7, scale=0.04)   # nb = 7: odd
    if not lower:
        d = gtt.MatrixData(d.shape, d.col_idx.copy(), d.row_idx.copy(),
                           d.values.copy()).canonical()
    arrays, meta = tri_packed.plan_packed_trisolve(d, lower, False,
                                                   device=dev)
    assert all(a.device.type == "cuda" for a in arrays.values())
    b = torch.randn((1700, k), dtype=bdtype, device=dev)
    before = tri_packed.packed_trisolve_cuda.launches
    x = tri_packed.packed_trisolve_cuda(arrays, meta, b)
    torch.cuda.synchronize()
    assert tri_packed.packed_trisolve_cuda.launches - before == 1
    assert x.dtype == bdtype
    want = tri_packed.packed_trisolve_reference(arrays, meta, b)
    assert _rel_err(x, want) <= 1e-5


# plans at the edges of the planner's caps: (n, entries a row, reach,
# seed, scale) giving P = 31 (cap 32) and Wv = 50 (cap 64)
EDGE_FACTORS = {"large_P": (40 * 256 + 77, 3, 31 * 256 - 40, 5, 0.05),
                "large_Wv": (1700, 220, 700, 7, 0.004)}


@pytest.mark.parametrize("k", [1, 3, 8, 9])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
@pytest.mark.parametrize("case", list(EDGE_FACTORS))
def test_tri_kernel_on_edge_plans(dev, case, lower, k):
    """Kernel C on a plan with P near its cap (the carry window fills most
    of the shared memory, so fewer columns a cluster) and one with a wide
    cross ELL (a large ring stage)."""
    d = random_lower_factor(*EDGE_FACTORS[case])
    if not lower:
        d = gtt.MatrixData(d.shape, d.col_idx.copy(), d.row_idx.copy(),
                           d.values.copy()).canonical()
    arrays, meta = tri_packed.plan_packed_trisolve(d, lower, False,
                                                   device=dev)
    P, Wv = dict(meta)["P"], dict(meta)["Wv"]
    assert (P >= 31) if case == "large_P" else (Wv >= 48)
    cfg = tri_packed.packed_trisolve_config(meta, k)
    assert cfg["cluster"] == 8 and cfg["stages"] >= 2
    assert 1 <= cfg["rhs_per_cluster"] <= min(k, 8)
    assert cfg["smem_bytes"] <= cfg["smem_limit"]
    b = torch.randn((d.shape[0], k), dtype=torch.float32, device=dev)
    x = tri_packed.packed_trisolve_cuda(arrays, meta, b)
    torch.cuda.synchronize()
    want = tri_packed.packed_trisolve_reference(arrays, meta, b)
    assert _rel_err(x, want) <= 1e-5


def test_tri_kernel_raises_on_a_window_the_card_refuses(dev):
    """A plan whose carry window cannot fit in shared memory beside two
    ring stages (P = 200, beyond the planner's cap of 32) is refused by
    CUDA, and the error reaches the caller and is not left behind for later
    calls."""
    d = random_lower_factor(1200, 5, 400, 9, scale=0.04)
    arrays, meta = tri_packed.plan_packed_trisolve(d, True, False,
                                                   device=dev)
    meta_items = tuple(sorted(dict(dict(meta), P=200).items()))
    cfg = tri_packed.packed_trisolve_config(meta_items, 1)
    assert cfg["smem_bytes"] > cfg["smem_limit"]
    b = torch.randn((1200, 1), device=dev)
    before = tri_packed.packed_trisolve_cuda.launches
    with pytest.raises(RuntimeError, match="tri_packed kernel launch failed"):
        tri_packed.packed_trisolve_cuda(arrays, meta_items, b)
    assert tri_packed.packed_trisolve_cuda.launches == before
    torch.cuda.synchronize()
    assert float((b * 2).sum()) == pytest.approx(2 * float(b.sum()))


def _tf32_on(how):
    if how == "allow_tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
    elif how == "float32_matmul_precision":
        torch.set_float32_matmul_precision("high")
    else:
        torch.backends.cuda.matmul.fp32_precision = "tf32"


@pytest.fixture
def keep_matmul_flags():
    legacy = torch.get_float32_matmul_precision()
    cuda = torch.backends.cuda.matmul.fp32_precision
    mkldnn = torch.backends.mkldnn.matmul.fp32_precision
    yield
    torch.set_float32_matmul_precision(legacy)
    torch.backends.cuda.matmul.fp32_precision = cuda
    torch.backends.mkldnn.matmul.fp32_precision = mkldnn


@pytest.mark.parametrize("how", ["allow_tf32", "float32_matmul_precision",
                                 "fp32_precision"])
def test_inverses_stay_full_f32_under_tf32(dev, how, keep_matmul_flags,
                                           monkeypatch):
    """A caller that turned TF32 on still gets full-f32 block inverses,
    and keeps its setting."""
    g = np.random.default_rng(0)
    Lb = np.tril(g.standard_normal((4, 256, 256)) * 0.1, -1)
    Lb[:, np.arange(256), np.arange(256)] = 2.0 + g.random((4, 256))
    want = np.linalg.inv(Lb)
    Lt = torch.from_numpy(Lb).float().to(dev)

    def err():
        got = tri_inv.batched_lowtri_inverse(Lt).double().cpu().numpy()
        return max(float(np.abs(got[i] - want[i]).max()
                         / np.abs(want[i]).max()) for i in range(4))

    _tf32_on(how)
    flag = torch.backends.cuda.matmul.fp32_precision
    assert err() <= 1e-5
    assert torch.backends.cuda.matmul.fp32_precision == flag
    # the same products without the guard lose about 1e-4: TF32 was on
    monkeypatch.setattr(tri_inv, "_full_f32_matmul", contextlib.nullcontext)
    assert err() > 1e-5


def test_tri_wrapper_raises_instead_of_falling_back(dev):
    d = random_lower_factor(1200, 5, 400, 9, scale=0.04)
    arrays, meta = tri_packed.plan_packed_trisolve(d, True, False,
                                                   device=dev)
    b = torch.randn((1200, 2), dtype=torch.float32, device=dev)
    with pytest.raises(TypeError):
        tri_packed.packed_trisolve_cuda(arrays, meta, b.half())
    with pytest.raises(ValueError, match="contiguous"):
        tri_packed.packed_trisolve_cuda(arrays, meta, b.t().contiguous().t())
    with pytest.raises(ValueError, match="one device"):
        tri_packed.packed_trisolve_cuda(
            {name: a.cpu() for name, a in arrays.items()}, meta, b)
    # the kernel copies the plan in 16-byte units
    inv = arrays["inv"]
    shifted = torch.empty(inv.numel() + 1, device=dev)[1:].view(inv.shape)
    shifted.copy_(inv)
    with pytest.raises(ValueError, match="16-byte"):
        tri_packed.packed_trisolve_cuda(dict(arrays, inv=shifted), meta, b)
    assert registry.lookup("packed_trisolve", dev) is \
        tri_packed.packed_trisolve_cuda


def test_ilu_bicgstab_on_card_matches_host(dev):
    data = build_matrix_data({"fem": 4096, "offscale": 1.2})
    b = np.random.default_rng(2).standard_normal((4096, 3)).astype(
        np.float32)
    crit = Iteration(300) | ResidualNorm(1e-5)
    out = []
    for device in (dev, torch.device("cpu")):
        A = gtt.Csr.from_data(data, dtype=np.float32, strategy="packed",
                              device=device)
        M = Ilu(factorization=ParIlu(5)).generate(A)
        assert M.l_solver.algorithm == M.u_solver.algorithm == \
            "exact_packed"
        out.append(Bicgstab.solve(A, torch.from_numpy(b).to(device),
                                  criteria=crit, preconditioner=M))
    rg, rc = out
    assert bool(rg.converged.all()) and bool(rc.converged.all())
    assert int((rg.iterations.cpu() - rc.iterations).abs().max()) <= 1
    assert _rel_err(rg.x.cpu(), rc.x) <= 1e-4


# -- kernels D and E: pair contraction ------------------------------------------
PAIR_MODES = {"cumsum_batched": pair_contract.pair_contract_cumsum_cuda,
              "onehot": pair_contract.pair_contract_onehot_cuda}
PAIR_STREAMS = ("pls", "pus", "pos", "pes", "pesp", "lq", "uq", "nv", "lbase",
                "ubase")


def _spill_plan():
    """Pairs past a per-tile budget of 4 vregs spill to the COO tail."""
    rng = np.random.default_rng(1)
    po = np.sort(rng.integers(0, 1024, 40000))
    pl = rng.integers(0, 2048, len(po))
    pu = rng.integers(0, 2048, len(po))
    plan = pair_contract.plan_pair_contract(pl, pu, po, 1024, 2048, 2048,
                                            nv_cap=4, max_tail=1.0)
    assert len(plan["tail"][0]) > 0
    return plan, (pl, pu, po, 1024, 2048, 2048)


def _shifted_plan():
    """A wide-spread list that plans only at coarse windows (shifts > 0)."""
    rng = np.random.default_rng(3)
    n_out, n_a, n_b = 50000, 30000, 35000
    po = np.repeat(np.arange(n_out), rng.poisson(4.0, n_out))
    m = len(po)
    pl = np.clip((po * n_a) // n_out + rng.integers(-3000, 3000, m),
                 0, n_a - 1)
    pu = np.clip((po * n_b) // n_out + rng.integers(-20000, 20000, m),
                 0, n_b - 1)
    shifts = pair_contract._select_shifts(pl, pu, po, n_out,
                                          pair_contract._NV_CAP)
    assert shifts != (0, 0)
    plan = pair_contract.plan_pair_contract(pl, pu, po, n_out, n_a, n_b,
                                            shifts=shifts)
    return plan, (pl, pu, po, n_out, n_a, n_b)


def _empty_tile_plan():
    """Tile 1 holds no pair (nv[1] == 0)."""
    rng = np.random.default_rng(4)
    po = np.sort(np.concatenate([rng.integers(0, 1024, 3000),
                                 rng.integers(2048, 3000, 3000)]))
    pl = np.clip(po + rng.integers(-100, 100, po.size), 0, 2999)
    pu = np.clip(po + rng.integers(-100, 100, po.size), 0, 2999)
    plan = pair_contract.plan_pair_contract(pl, pu, po, 3000, 3000, 3000)
    assert plan["nv"][1] == 0
    return plan, (pl, pu, po, 3000, 3000, 3000)


def _near_cap_plan():
    """One tile of 90 live vregs (9 x 10 window blocks of about 670
    pairs), next to the planner's cap of 96."""
    rng = np.random.default_rng(10)
    po = np.sort(rng.integers(0, 1024, 60000))
    pl = rng.integers(0, 9 * 1024, len(po))
    pu = rng.integers(0, 10 * 1024, len(po))
    plan = pair_contract.plan_pair_contract(pl, pu, po, 1024, 9 * 1024,
                                            10 * 1024)
    assert 88 <= plan["nv"][0] <= pair_contract._NV_CAP
    return plan, (pl, pu, po, 1024, 9 * 1024, 10 * 1024)


def _pair_args(plan, lists, dtype, dev):
    """Operands, the plan's slabs (for the plain version) and its pad-free
    stream (for the kernels) on the card."""
    g = np.random.default_rng(9)
    a = torch.from_numpy(g.standard_normal(lists[4])).to(dev, dtype)
    b = torch.from_numpy(g.standard_normal(lists[5])).to(dev, dtype)
    arrs = {k: torch.from_numpy(plan[k]).to(dev) for k in PAIR_STREAMS}
    arrs["tail"] = tuple(torch.from_numpy(t).to(dev).long()
                         for t in plan["tail"])
    arrs["stream"] = pair_contract.pair_stream(arrs, plan["meta"])
    return a, b, arrs


@pytest.fixture
def dot_mode():
    prev = pair_contract._DOT_MODE
    yield
    pair_contract._DOT_MODE = prev


def _pair_oracle(a, b, lists, dev):
    return pair_contract.pair_contract_reference(
        a.double(), b.double(), *(torch.from_numpy(np.asarray(x)).to(dev)
                                  for x in lists[:3]), lists[3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("mode", list(PAIR_MODES))
@pytest.mark.parametrize("make", [_spill_plan, _shifted_plan,
                                  _empty_tile_plan, _near_cap_plan],
                         ids=["spill", "shifted", "empty_tile", "near_cap"])
def test_pair_kernels_match_plain(dev, make, mode, dtype, dot_mode):
    plan, lists = make()
    a, b, arrs = _pair_args(plan, lists, dtype, dev)
    kernel = PAIR_MODES[mode]
    pair_contract._DOT_MODE = mode
    before = kernel.launches
    y = pair_contract.pair_contract_planned_cuda(a, b, arrs, plan["meta"])
    torch.cuda.synchronize()
    assert kernel.launches - before == 1
    assert y.dtype == dtype and y.device.type == "cuda"
    want = pair_contract.pair_contract_planned_reference(a, b, arrs,
                                                         plan["meta"])
    oracle = _pair_oracle(a, b, lists, dev)
    # f32: sums in other orders (kernel E's atomics in a changing order,
    # the plain kernel D's cumsum difference losing digits to cancellation)
    tol = {torch.float32: 2e-5 if mode == "onehot" else 1e-5,
           torch.float64: 1e-12}[dtype]
    assert _rel_err(y, want) <= tol
    assert _rel_err(y, oracle) <= tol
    if make is _empty_tile_plan:
        assert bool((y[1024:2048] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("make", [_spill_plan, _shifted_plan,
                                  _empty_tile_plan, _near_cap_plan],
                         ids=["spill", "shifted", "empty_tile", "near_cap"])
def test_pair_kernel_d_is_its_emulation_bit_for_bit(dev, make, dtype):
    """Kernel D run twice gives the same bits, and they are the emulated
    walk's and tail's (tests/pair_walk.py); kernel E agrees with the
    emulation to its tolerance."""
    plan, lists = make()
    a, b, arrs = _pair_args(plan, lists, dtype, dev)
    y1 = pair_contract.pair_contract_cumsum_cuda(a, b, arrs, plan["meta"])
    y2 = pair_contract.pair_contract_cumsum_cuda(a, b, arrs, plan["meta"])
    assert torch.equal(y1, y2)
    st = {k: v.cpu() for k, v in arrs["stream"].items()}
    emu = pair_walk.walk(a.cpu(), b.cpu(), st, plan["meta"], "cumsum_batched")
    emu = pair_walk.tail(a.cpu(), b.cpu(), st, emu)
    assert torch.equal(y1.cpu(), emu)
    ye = pair_contract.pair_contract_onehot_cuda(a, b, arrs, plan["meta"])
    tol = {torch.float32: 2e-5, torch.float64: 1e-12}[dtype]
    assert _rel_err(ye.cpu(), emu) <= tol


def test_pair_kernel_refused_launch_raises(dev):
    """A stream not 16-byte aligned (the kernels' index loads) is refused
    by the launch and the wrappers raise, counting no launch."""
    plan, lists = _spill_plan()
    a, b, arrs = _pair_args(plan, lists, torch.float32, dev)
    st = arrs["stream"]
    for key in ("cl", "cu", "co"):
        shifted = torch.empty(st[key].numel() + 8, dtype=torch.int16,
                              device=dev)[1:1 + st[key].numel()]
        shifted.copy_(st[key])
        bad = dict(arrs, stream=dict(st, **{key: shifted}))
        for fn in PAIR_MODES.values():
            before = fn.launches
            with pytest.raises(RuntimeError, match="launch failed"):
                fn(a, b, bad, plan["meta"])
            assert fn.launches == before


def test_pair_wrappers_raise_instead_of_falling_back(dev):
    plan, lists = _spill_plan()
    a, b, arrs = _pair_args(plan, lists, torch.float32, dev)
    meta = plan["meta"]
    for fn in PAIR_MODES.values():
        with pytest.raises(TypeError):
            fn(a, b.double(), arrs, meta)
        with pytest.raises(TypeError):
            fn(a.half(), b.half(), arrs, meta)
        with pytest.raises(NotImplementedError, match="queue 3"):
            fn(a.to(torch.complex64), b.to(torch.complex64), arrs, meta)
        with pytest.raises(ValueError, match="pair stream"):
            fn(a, b, {k: v for k, v in arrs.items() if k != "stream"}, meta)
        with pytest.raises(ValueError, match="one device"):
            fn(a, b, {k: (tuple(t.cpu() for t in v) if k == "tail"
                          else {n: t.cpu() for n, t in v.items()}
                          if k == "stream" else v.cpu())
                      for k, v in arrs.items()}, meta)
        with pytest.raises(ValueError):
            fn(a[:-1].repeat(2), b, arrs, meta)      # longer than the plan
        bad = dict(arrs, stream=dict(arrs["stream"],
                                     cl=arrs["stream"]["cl"].int()))
        with pytest.raises(ValueError):
            fn(a, b, bad, meta)
    assert registry.lookup("pair_contract_planned", dev) is \
        pair_contract.pair_contract_planned_cuda


def test_shipped_pair_stream_is_kept_across_modes(dev, dot_mode):
    """On the card both kernels read one stream, so switching
    ``_DOT_MODE`` (as the one-hot generate does) reuses the shipped stream
    instead of shipping the slabs and repacking again."""
    from ginkgo_tpu_torch.factorization import par_ilut_packed
    plan, _ = _spill_plan()
    cplan = {"kernel": plan}
    pair_contract._DOT_MODE = "cumsum_batched"
    first = par_ilut_packed._ship_contract(cplan, dev)
    assert set(first[0]) == {"stream"}
    pair_contract._DOT_MODE = "onehot"
    assert par_ilut_packed._ship_contract(cplan, dev) is first


@pytest.mark.parametrize("case", ["ilut", "ict"])
def test_packed_parilut_on_card_matches_host(dev, case):
    """Packed ParILUT/ParICT on the card (kernel D, f64) against the host
    (raw triples): same patterns, values to 1e-10 relative."""
    data = random_banded(3000, 40, 8, seed=1)
    P = ParIlut
    if case == "ict":
        data, P = symmetric_part(data), ParIct
    before = pair_contract.pair_contract_cumsum_cuda.launches
    Fg = P(iterations=3, algorithm="packed").generate(
        gtt.Csr.from_data(data, device=dev))
    assert pair_contract.pair_contract_cumsum_cuda.launches > before
    assert Fg.route == "packed"
    Fc = P(iterations=3, algorithm="packed").generate(
        gtt.Csr.from_data(data, device="cpu"))
    for name in ("l_factor", "u_factor"):
        g = getattr(Fg, name).to_matrix_data()
        c = getattr(Fc, name).to_matrix_data()
        assert np.array_equal(g.row_idx, c.row_idx)
        assert np.array_equal(g.col_idx, c.col_idx)
        np.testing.assert_allclose(g.values, c.values, rtol=1e-10,
                                   atol=1e-10 * np.abs(c.values).max())


# -- kernel F: the in-place Krylov-basis row write -----------------------------
ROW_DTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.float16,
              torch.int16, torch.int8, torch.complex64, torch.complex128]


def _random_rows(shape, dtype, seed):
    g = np.random.default_rng(seed)
    vals = g.standard_normal(shape)
    if dtype.is_complex:
        vals = vals + 1j * g.standard_normal(shape)
    elif not dtype.is_floating_point:
        vals = np.clip(np.round(vals * 40), -120, 120)
    return torch.from_numpy(vals).to(dtype)


@pytest.mark.parametrize("dtype", ROW_DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(13, 1003), (13, 1003, 3), (9, 4096)],
                         ids=["2d_ragged", "3d", "2d_aligned"])
def test_row_write_kernel_matches_copy(dev, shape, dtype):
    """Bit for bit the plain ``copy_``; other rows untouched; the store is
    written in place and nothing is allocated."""
    store = _random_rows(shape, dtype, 0).to(dev)
    want = store.clone()
    rows = [_random_rows(shape[1:], dtype, i + 1).to(dev) for i in range(3)]
    ptr, mem = store.data_ptr(), torch.cuda.memory_allocated()
    before = row_write.row_write_cuda.launches
    for i, row in zip((0, 5, shape[0] - 1), rows):
        assert row_write.row_write_cuda(store, i, row) is store
        want[i].copy_(row)
    torch.cuda.synchronize()
    assert row_write.row_write_cuda.launches - before == 3
    assert store.data_ptr() == ptr
    assert torch.cuda.memory_allocated() <= mem
    assert torch.equal(store.view(torch.uint8), want.view(torch.uint8))


# the kernel's ring: chunks of 16 KB, 4 stages, 2 CTAs an SM; row lengths
# in bytes around one chunk, one ring and more chunks than CTAs
RING_BYTES = [16, 16384 - 16, 16384, 16384 + 16, 4 * 16384, 4 * 16384 + 48,
              300 * 16384 + 32]


@pytest.mark.parametrize("dtype", ROW_DTYPES, ids=str)
def test_row_write_kernel_ring_lengths_and_misalignment(dev, dtype):
    """Bit for bit ``copy_`` at row lengths around the ring's chunks, with
    the row and the store's row starting at every element offset within 16
    bytes (aligned alike or not), the rows beside it untouched."""
    esize = torch.empty((), dtype=dtype).element_size()
    g = torch.Generator(device=dev).manual_seed(0)

    def random_bits(count):      # any bit pattern: copies are compared
        return torch.randint(0, 256, (count * esize,), dtype=torch.uint8,
                             device=dev, generator=g).view(dtype)
    for nbytes in RING_BYTES:
        n = max(1, nbytes // esize + (1 if esize < 16 else 0))
        for off in range(0, max(1, 16 // esize)):
            for src_off in sorted({0, off}):
                store = random_bits(3 * n + off)[off:].view(3, n)
                want = store.clone()
                row = random_bits(n + src_off)[src_off:]
                assert row_write.row_write_cuda(store, 1, row) is store
                want[1].copy_(row)
                torch.cuda.synchronize()
                assert torch.equal(store.view(torch.uint8),
                                   want.view(torch.uint8)), (nbytes, off,
                                                             src_off)


def test_row_write_wrapper_raises_instead_of_falling_back(dev):
    store = torch.zeros((4, 256), dtype=torch.float32, device=dev)
    row = torch.ones(256, dtype=torch.float32, device=dev)
    with pytest.raises(TypeError, match="cast the row"):
        row_write.row_write_cuda(store, 1, row.double())
    with pytest.raises(ValueError, match="contiguous"):
        row_write.row_write_cuda(store.t().contiguous().t(), 1, row)
    with pytest.raises(ValueError, match="not a row"):
        row_write.row_write_cuda(store, 1, row[:-1])
    with pytest.raises(IndexError):
        row_write.row_write_cuda(store, 4, row)
    with pytest.raises(ValueError, match="one device"):
        row_write.row_write_cuda(store, 1, row.cpu())
    assert registry.lookup("row_write", dev) is row_write.row_write_cuda


# -- kernels G and H: the attic SpMV generations ---------------------------------
ATTIC = {"windowed": (spmv_windowed, "plan_windowed_layout", "well_spmv",
                      dict(h_quantile=0.5)),
         "chunked": (spmv_chunked, "plan_chunked_layout", "cell_spmv",
                     dict(wv_cap=2))}


def _attic_plan(kind, dev, capped):
    mod, planner, name, cap = ATTIC[kind]
    d = build_matrix_data({"fem": 4096, "offscale": 1.2})
    vals = d.values.astype(np.float32)
    layout, tail, stats = getattr(mod, planner)(d, vals,
                                                **(cap if capped else {}))
    assert stats["tail_nnz"] > 0 or not capped
    return mod, name, mod.upload(layout, tail, dev), d


def _attic_args(t):
    """The kernel wrapper's layout arguments: the slab's compact stream
    (G's and H's alike)."""
    return [t["sell"], t["sell_meta"]]


@pytest.mark.parametrize("k", [1, 3, 8, 9])
@pytest.mark.parametrize("capped", [False, True], ids=["", "capped"])
@pytest.mark.parametrize("kind", list(ATTIC))
def test_attic_kernels_match_plain(dev, kind, capped, k):
    mod, name, t, d = _attic_plan(kind, dev, capped)
    kernel = getattr(mod, f"{name}_cuda")
    x = torch.randn((d.shape[1], k), dtype=torch.float32, device=dev)
    before = kernel.launches
    y = kernel(*_attic_args(t), x)
    torch.cuda.synchronize()
    assert kernel.launches - before == -(-k // 8)
    # against the slab's plain version and the stream's
    slab = [t[key] for key in mod.ARRAYS]
    want = getattr(mod, f"{name}_reference")(*slab, t["meta"], x)
    assert _rel_err(y, want) <= 1e-5
    assert _rel_err(y, spmv_sell.sell_spmv_reference(
        t["sell"], t["sell_meta"], x)) <= 1e-5
    # the apply (kernel plus the COO tail) against an f64 product
    y = getattr(mod, f"{name}_apply")(t, x)
    A = torch.sparse_coo_tensor(
        np.stack([d.row_idx, d.col_idx]),
        d.values.astype(np.float32).astype(np.float64), d.shape).to(dev)
    assert _rel_err(y, A @ x.double()) <= 1e-5


def test_attic_wrappers_raise_instead_of_falling_back(dev):
    for kind in ATTIC:
        mod, name, t, d = _attic_plan(kind, dev, False)
        kernel = getattr(mod, f"{name}_cuda")
        args = _attic_args(t)
        f64 = [dict(args[0], sv=args[0]["sv"].double()), args[1]]
        on_cpu = [dict(args[0], sv=args[0]["sv"].cpu()), args[1]]
        x = torch.ones((d.shape[1], 2), dtype=torch.float32, device=dev)
        with pytest.raises(TypeError):
            kernel(*args, x.double())
        with pytest.raises(TypeError):
            kernel(*f64, x)
        with pytest.raises(ValueError):
            kernel(*args, x[:-1])
        with pytest.raises(ValueError, match="contiguous"):
            kernel(*args, x.t().contiguous().t())
        with pytest.raises(ValueError, match="one device"):
            kernel(*on_cpu, x)
        assert registry.lookup(name, dev) is kernel


# -- GMRES on the card against the host ------------------------------------------
@pytest.mark.parametrize("storage", ["keep", "reduce1", "integer"])
def test_gmres_on_card_matches_host(dev, storage):
    """f64, two right-hand sides, restarts (krylov_dim 20): the card (kernel
    F for the basis writes, kernel B for the SpMV) against the host."""
    data = build_matrix_data({"fem": 4096, "offscale": 1.2})
    b = np.random.default_rng(4).standard_normal((4096, 2))
    out = []
    for device in (dev, torch.device("cpu")):
        A = gtt.Csr.from_data(data, device=device)
        before = row_write.row_write_cuda.launches
        res = CbGmres.solve(A, torch.from_numpy(b).to(device),
                            criteria=Iteration(400) | ResidualNorm(1e-10),
                            krylov_dim=20, storage_precision=storage)
        out.append((res, row_write.row_write_cuda.launches - before))
    (rg, ng), (rc, nc) = out
    assert ng > 0 and nc == 0
    assert bool(rg.converged.all())
    assert torch.equal(rg.iterations.cpu(), rc.iterations)
    assert torch.equal(rg.converged.cpu(), rc.converged)
    assert torch.equal(rg.stagnated.cpu(), rc.stagnated)
    torch.testing.assert_close(rg.x.cpu(), rc.x, rtol=1e-10, atol=1e-10)


FORMAT_NAMES = ["Coo", "Ell", "Sellp", "Hybrid", "Fbcsr"]


@pytest.mark.parametrize("vdtype", [np.float32, np.complex64],
                         ids=["f32", "c64"])
@pytest.mark.parametrize("kind", ["banded", "packed"])
@pytest.mark.parametrize("fmt", FORMAT_NAMES)
def test_format_plans_apply_as_csr_bit_for_bit(dev, fmt, kind, vdtype):
    """Each format's SpmvPlan carries the planned Csr's arrays, so its
    apply on the card launches the same kernel once and gives the Csr's
    y bit for bit."""
    base = (stencil_3d(12, points=27) if kind == "banded"
            else permute_locally(stencil_3d(16, 16, 8, points=27)))
    scale = 1 + 0.25j if vdtype == np.complex64 else 1
    d = gtt.MatrixData(base.shape, base.row_idx, base.col_idx,
                       (base.values * scale).astype(vdtype))
    A = gtt.Csr.from_data(d, device=dev)
    F = getattr(gtt, fmt).from_data(d, device=dev)
    assert A.strategy == F.fast_op.strategy == kind
    counter = {("banded", np.float32): spmv_banded.dia_spmv_cuda,
               ("banded", np.complex64): spmv_banded.dia_spmv_complex_cuda,
               ("packed", np.float32): spmv_packed.pell_spmv_cuda,
               ("packed", np.complex64): spmv_packed.pell_spmv_complex_cuda
               }[(kind, vdtype)]
    x = torch.randn((d.shape[0], 3), device=dev,
                    dtype=torch.complex64 if vdtype == np.complex64
                    else torch.float32)
    before = counter.launches
    y = F.apply(x)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(y, A.apply(x))


@pytest.mark.parametrize("how", ["scale", "inv_scale", "astype"])
@pytest.mark.parametrize("kind", ["banded", "packed"])
def test_csr_value_maps_on_card_match_cpu(dev, kind, how):
    """scale / inv_scale by a scalar tensor on the card and astype map the
    host slab, the card stream and the device arrays alike: each value
    tensor equals the CPU run's bit for bit, and the kernel's apply
    equals that of a Csr planned on the card from the mapped entries."""
    base = (stencil_3d(12, points=27) if kind == "banded"
            else permute_locally(stencil_3d(16, 16, 8, points=27)))
    maps = {"scale": lambda A, dv: A.scale(torch.tensor(1.7, device=dv)),
            "inv_scale": lambda A, dv: A.inv_scale(
                torch.tensor(1.7, dtype=torch.float64, device=dv)),
            "astype": lambda A, dv: A.astype(torch.float32)}
    got, want = (maps[how](gtt.Csr.from_data(base, device=device), device)
                 for device in (dev, torch.device("cpu")))
    assert got.strategy == want.strategy == kind
    for name in ("values", "diag_values", "tail_vals", "pell_vals"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert torch.equal(g.cpu(), w), name
    if kind == "packed":
        assert got.pell_vals.device.type == "cpu"
        assert got.sell["sv"].device.type == "cuda"
        assert torch.equal(got.sell["sv"].cpu(), want.sell["sv"])
    ref = gtt.Csr.from_data(want.to_matrix_data(), dtype=got.dtype,
                            device=dev)
    x = torch.randn((base.shape[0], 2), device=dev, dtype=got.dtype)
    assert torch.equal(got.apply(x), ref.apply(x))


def test_tensorless_operator_to_dense_lands_on_the_card(dev):
    eye = gtt.Identity(5).to_dense()
    assert eye.device.type == "cuda"
    assert torch.equal(eye.cpu(), torch.eye(5))
