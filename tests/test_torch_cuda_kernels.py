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
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.factorization import ParIct, ParIlu, ParIlut
from ginkgo_tpu_torch.ops import (pair_contract, registry, spmv_banded,
                                  spmv_packed, tri_inv, tri_packed)
from ginkgo_tpu_torch.preconditioner import Ilu, Jacobi
from ginkgo_tpu_torch.solver import Bicgstab, Cg
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


def _pair_args(plan, lists, dtype, dev):
    g = np.random.default_rng(9)
    a = torch.from_numpy(g.standard_normal(lists[4])).to(dev, dtype)
    b = torch.from_numpy(g.standard_normal(lists[5])).to(dev, dtype)
    arrs = {k: torch.from_numpy(plan[k]).to(dev) for k in PAIR_STREAMS}
    arrs["tail"] = tuple(torch.from_numpy(t).to(dev).long()
                         for t in plan["tail"])
    return a, b, arrs


@pytest.fixture
def dot_mode():
    prev = pair_contract._DOT_MODE
    yield
    pair_contract._DOT_MODE = prev


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("mode", list(PAIR_MODES))
@pytest.mark.parametrize("make", [_spill_plan, _shifted_plan,
                                  _empty_tile_plan],
                         ids=["spill", "shifted", "empty_tile"])
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
    oracle = pair_contract.pair_contract_reference(
        a.double(), b.double(), *(torch.from_numpy(np.asarray(x)).to(dev)
                                  for x in lists[:3]), lists[3])
    # f32: sums in other orders (kernel E's atomics in a changing order,
    # kernel D's cumsum difference losing digits to cancellation)
    tol = {torch.float32: 2e-5 if mode == "onehot" else 1e-5,
           torch.float64: 1e-12}[dtype]
    assert _rel_err(y, want) <= tol
    assert _rel_err(y, oracle) <= tol
    if make is _empty_tile_plan:
        assert bool((y[1024:2048] == 0).all())


def test_pair_wrappers_raise_instead_of_falling_back(dev):
    plan, lists = _spill_plan()
    a, b, arrs = _pair_args(plan, lists, torch.float32, dev)
    meta = plan["meta"]
    for fn in PAIR_MODES.values():
        with pytest.raises(TypeError):
            fn(a, b.double(), arrs, meta)
        with pytest.raises(TypeError):
            fn(a.half(), b.half(), arrs, meta)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(a.to(torch.complex64), b.to(torch.complex64), arrs, meta)
        with pytest.raises(ValueError, match="one device"):
            fn(a, b, {k: (tuple(t.cpu() for t in v) if k == "tail"
                          else v.cpu()) for k, v in arrs.items()}, meta)
        with pytest.raises(ValueError):
            fn(a[:-1].repeat(2), b, arrs, meta)      # longer than the plan
        bad = dict(arrs, pls=arrs["pls"].int())
        with pytest.raises(ValueError):
            fn(a, b, bad, meta)
    assert registry.lookup("pair_contract_planned", dev) is \
        pair_contract.pair_contract_planned_cuda


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
