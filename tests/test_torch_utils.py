"""The utilities (``utils/{timer,checkpoint,interop,export,
compile_cache}.py``): the counterparts of ``tests/test_utils_extra.py``'s
timer, checkpoint and export cases, ``tests/test_interop.py`` (torch's
sparse COO and CSR tensors in the place of BCOO and BCSR, held against the
reference's arrays) and ``tests/test_compile_cache.py``, on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental import sparse as jsparse

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.utils import interop as jinterop
from ginkgo_tpu_torch import Csr
from ginkgo_tpu_torch.base.exceptions import NotSupportedError
from ginkgo_tpu_torch.base.matrix_data import MatrixData
from ginkgo_tpu_torch.solver import Cg, cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils import (CpuTimer, DeviceTimer, from_scipy,
                                    from_sparse_coo, from_sparse_csr,
                                    to_scipy, to_sparse_coo, to_sparse_csr,
                                    topology)
from ginkgo_tpu_torch.utils.checkpoint import load, save
from ginkgo_tpu_torch.utils.compile_cache import enable_compilation_cache
from ginkgo_tpu_torch.utils.export import (export_solve, load_solve,
                                           serialize_solve, value_tensors)
from ginkgo_tpu_torch.utils.generators import (generate_random_matrix,
                                               make_spd, permute_locally,
                                               stencil_2d, stencil_3d)

CPU = "cpu"


# -- timers ----------------------------------------------------------------------

def test_timers_and_topology():
    t = CpuTimer()
    t.tic()
    assert t.toc() >= 0
    dt = DeviceTimer(device=CPU)
    dt.tic()
    y = torch.ones(1000).sum()
    first = dt.toc(y)
    assert first >= 0
    dt.tic()
    assert dt.toc() >= first          # accumulates, as the reference's
    topo = topology()
    assert topo["num_devices"] >= 1 and topo["devices"]
    assert topo["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")


def test_device_timer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        DeviceTimer()


# -- checkpoint ---------------------------------------------------------------------

def _roundtrip(tmp_path, obj, name="obj.pt"):
    path = str(tmp_path / name)
    save(path, obj)
    assert os.path.exists(path)
    return load(path, device=CPU)


@pytest.mark.parametrize("case", ["classical", "banded", "packed"])
def test_checkpoint_roundtrip_csr(tmp_path, case):
    data = {"classical": lambda: generate_random_matrix(
                30, 30, nonzeros_per_row=(1, 5), seed=0),
            "banded": lambda: stencil_2d(6, points=5),
            "packed": lambda: permute_locally(stencil_3d(16, 8, 8,
                                                         points=27))}[case]()
    A = Csr.from_data(data, device=CPU,
                      strategy="classical" if case == "classical"
                      else "automatical")
    assert A.strategy == case
    B = _roundtrip(tmp_path, A)
    assert isinstance(B, Csr) and B.shape == A.shape
    assert B.strategy == A.strategy and B.band_meta == A.band_meta
    for a, b in zip(gtt.base.linop.tensor_leaves(A),
                    gtt.base.linop.tensor_leaves(B)):
        assert torch.equal(a, b)
    if case == "packed":
        assert B.pell_vals.device.type == "cpu" and B.sell is not None
    x = torch.ones(A.shape[0], dtype=torch.float64)
    assert torch.equal(B.apply(x), A.apply(x))
    np.testing.assert_array_equal(B.to_dense().numpy(), A.to_dense().numpy())


def test_checkpoint_roundtrip_factorization(tmp_path):
    from ginkgo_tpu_torch.factorization import ParIlu
    A = Csr.from_data(stencil_2d(5, points=5), device=CPU)
    f = ParIlu(iterations=5).generate(A)
    g = _roundtrip(tmp_path, f)
    np.testing.assert_array_equal(g.l_factor.to_dense().numpy(),
                                  f.l_factor.to_dense().numpy())
    np.testing.assert_array_equal(g.u_factor.to_dense().numpy(),
                                  f.u_factor.to_dense().numpy())


def test_checkpoint_roundtrip_multigrid_and_result(tmp_path):
    from ginkgo_tpu_torch.solver import Multigrid
    A = Csr.from_data(stencil_3d(10, points=7), device=CPU)
    mg = Multigrid.build().generate(A)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    crit = Iteration(100) | ResidualNorm(1e-10)
    res = Cg.solve(A, b, criteria=crit, preconditioner=mg.cycle_operator())
    mg2 = _roundtrip(tmp_path, mg, "mg.pt")
    res2 = Cg.solve(A, b, criteria=crit, preconditioner=mg2.cycle_operator())
    assert torch.equal(res.iterations, res2.iterations)
    assert torch.equal(res.x, res2.x)
    back = _roundtrip(tmp_path, res, "res.pt")
    for name in ("x", "iterations", "resnorm", "converged", "stagnated"):
        assert torch.equal(getattr(back, name), getattr(res, name)), name


def test_checkpoint_keeps_shared_tensors_shared(tmp_path):
    from ginkgo_tpu_torch.batch import BatchCsr
    d = stencil_2d(4, points=5)
    B = BatchCsr.from_data((d, np.stack([d.values, 2 * d.values])),
                           device=CPU)
    C = _roundtrip(tmp_path, {"a": B, "b": B, "t": (B.values, B.values)})
    assert C["a"] is C["b"] and C["t"][0] is C["t"][1]
    assert torch.equal(C["a"].values, B.values)


def test_checkpoint_load_defaults_to_cuda(tmp_path, monkeypatch):
    path = str(tmp_path / "A.pt")
    save(path, Csr.from_data(stencil_2d(4, points=5), device=CPU))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        load(path)


# -- export -----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["classical", "banded"])
def test_export_solve_roundtrip(case):
    """A configured CG solve serializes and runs after deserialization
    with NEW matrix values on the same pattern, giving the direct
    solve's x."""
    data = make_spd(generate_random_matrix(
        16, 16, nonzeros_per_row=(1, 4), seed=40), shift=1.5) \
        if case == "classical" else stencil_3d(4, points=27)
    A = Csr.from_data(data, dtype=np.float32, device=CPU)
    assert A.strategy == case
    n = A.shape[0]
    crit = Iteration(200) | ResidualNorm(1e-6)
    blob = serialize_solve(cg.solve, A, torch.empty(
        n, dtype=torch.float32, device="meta"), criteria=crit)
    assert isinstance(blob, bytes) and len(blob) > 100
    run = load_solve(blob)
    b = torch.ones(n, dtype=torch.float32)
    x = run(A, b)
    assert torch.equal(x, cg.solve(A, b, criteria=crit).x)
    np.testing.assert_allclose(data.to_dense() @ x.numpy(), 1.0, rtol=1e-4,
                               atol=1e-4)
    A2 = A.scale(2.0)
    x2 = run(A2, b)
    np.testing.assert_allclose(x2.numpy(), x.numpy() / 2.0, rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(run(value_tensors(A2), b), x2)


def test_export_checks_its_inputs():
    A = Csr.from_data(stencil_2d(4, points=5), device=CPU)
    ex = export_solve(cg.solve, A, torch.empty(16, dtype=torch.float64),
                      criteria=Iteration(50) | ResidualNorm(1e-8))
    with pytest.raises(ValueError, match="the solve takes"):
        ex.call(A, torch.ones(16, dtype=torch.float32))
    with pytest.raises(ValueError, match="the solve takes"):
        ex.call([v[:-1] for v in value_tensors(A)], torch.ones(16,
                                                     dtype=torch.float64))
    with pytest.raises(ValueError, match="value tensors"):
        ex.call(value_tensors(A) + value_tensors(A), torch.ones(
            16, dtype=torch.float64))


# -- interop ----------------------------------------------------------------------

def _random_scipy(n=37, m=29, density=0.12, dtype=np.float64):
    mat = sp.random(n, m, density=density,
                    random_state=np.random.RandomState(7),
                    dtype=np.float64, format="coo")
    if np.issubdtype(dtype, np.complexfloating):
        mat = (mat + 1j * sp.random(n, m, density=density, format="coo",
                                    random_state=np.random.RandomState(8))
               ).astype(dtype)
    return mat.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_scipy_roundtrip_and_apply(rng, dtype):
    m = _random_scipy(dtype=dtype)
    A = from_scipy(m, device=CPU)
    assert isinstance(A, Csr)
    Aj = jinterop.from_scipy(m)
    np.testing.assert_array_equal(A.values.numpy(), np.asarray(Aj.values))
    x = rng.standard_normal(m.shape[1]).astype(dtype)
    np.testing.assert_allclose(A.apply(torch.tensor(x)).numpy(), m @ x,
                               rtol=1e-12, atol=1e-12)
    back = to_scipy(A, format="csr")
    assert (back != m.tocsr()).nnz == 0


def test_scipy_duplicates_summed():
    m = sp.coo_matrix((np.array([1.0, 2.0, 5.0]),
                       (np.array([0, 0, 1]), np.array([1, 1, 0]))),
                      shape=(2, 2))
    A = from_scipy(m, device=CPU)
    np.testing.assert_allclose(A.to_dense().numpy(),
                               [[0.0, 3.0], [5.0, 0.0]])


def test_scipy_target_format_and_kwargs():
    m = _random_scipy()
    E = from_scipy(m.tocsc(), cls=gtt.Ell, device=CPU)
    assert isinstance(E, gtt.Ell)
    np.testing.assert_allclose(E.to_dense().numpy(), m.toarray(),
                               rtol=1e-14)
    C = from_scipy(m, strategy="classical", device=CPU)
    assert C.strategy == "classical"
    with pytest.raises(TypeError):
        from_scipy(np.eye(3))


def _dense(rng, shape, density):
    return np.where(rng.random(shape) < density,
                    rng.standard_normal(shape), 0.0)


def test_sparse_coo_roundtrip(rng):
    """torch sparse COO in the place of BCOO: the same operator as the
    reference's ``from_bcoo`` of the same matrix, and back."""
    dense = _dense(rng, (23, 23), 0.15)
    A = from_sparse_coo(torch.tensor(dense).to_sparse_coo(), device=CPU)
    Aj = jinterop.from_bcoo(jsparse.BCOO.fromdense(jnp.asarray(dense)))
    for name in ("row_ptr", "col_idx", "values"):
        np.testing.assert_array_equal(getattr(A, name).numpy(),
                                      np.asarray(getattr(Aj, name)))
    out = to_sparse_coo(A)
    assert out.layout == torch.sparse_coo and out.is_coalesced()
    np.testing.assert_array_equal(out.to_dense().numpy(), dense)
    ref = jinterop.to_bcoo(Aj)
    np.testing.assert_array_equal(out.indices().numpy().T,
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(out.values().numpy(), np.asarray(ref.data))


def test_sparse_csr_roundtrip(rng):
    dense = _dense(rng, (16, 24), 0.2)
    A = from_sparse_csr(torch.tensor(dense).to_sparse_csr(), device=CPU)
    Aj = jinterop.from_bcsr(jsparse.BCSR.fromdense(jnp.asarray(dense)))
    np.testing.assert_array_equal(A.to_dense().numpy(),
                                  np.asarray(Aj.to_dense()))
    out = to_sparse_csr(A)
    assert out.layout == torch.sparse_csr
    ref = jinterop.to_bcsr(Aj)
    np.testing.assert_array_equal(out.crow_indices().numpy(),
                                  np.asarray(ref.indptr))
    np.testing.assert_array_equal(out.col_indices().numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(out.to_dense().numpy(), dense)


def test_export_canonicalizes_unsorted_coo():
    """Coo stores entries in assembly order; the exporters canonicalize
    (sorted, duplicates summed) before marking their output coalesced."""
    data = MatrixData((3, 3), np.array([2, 0, 1, 0, 2]),
                      np.array([1, 2, 0, 2, 0]),
                      np.array([4.0, 1.5, 2.0, 0.5, 3.0]))
    dense = gtt.Coo.from_data(data, device=CPU).to_dense().numpy()
    out = to_sparse_coo(data, device=CPU)
    np.testing.assert_allclose(out.to_dense().numpy(), dense)
    idx = out.indices().numpy()
    keys = idx[0] * 3 + idx[1]
    assert np.all(keys[1:] > keys[:-1])
    outc = to_sparse_csr(data, device=CPU)
    np.testing.assert_allclose(outc.to_dense().numpy(), dense)
    indptr, cols = outc.crow_indices().numpy(), outc.col_indices().numpy()
    assert indptr[-1] == outc.values().shape[0]
    for r in range(3):
        seg = cols[indptr[r]:indptr[r + 1]]
        assert np.all(seg[1:] > seg[:-1])


def test_sparse_batched_and_hybrid_rejected():
    batched = torch.ones((2, 3, 3)).to_sparse_coo()
    with pytest.raises(NotSupportedError):
        from_sparse_coo(batched, device=CPU)
    hybrid = torch.ones((3, 3, 2)).to_sparse(sparse_dim=2)
    assert hybrid.dense_dim() == 1
    with pytest.raises(NotSupportedError):
        from_sparse_coo(hybrid, device=CPU)
    batched_csr = torch.ones((2, 3, 3)).to_sparse_csr()
    with pytest.raises(NotSupportedError):
        from_sparse_csr(batched_csr, device=CPU)
    with pytest.raises(TypeError):
        from_sparse_csr(torch.ones((2, 2)).to_sparse_coo(), device=CPU)


def test_solver_drive_from_scipy():
    """End-to-end: assemble in scipy, solve in the port."""
    n = 64
    m = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n), format="csr")
    A = from_scipy(m, device=CPU)
    solver = gtt.solver.Cg.build(
        criteria=gtt.stop.Iteration(200) | gtt.stop.ResidualNorm(1e-10)
    ).generate(A)
    x = solver.apply(torch.ones(n, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(m @ x, np.ones(n), atol=1e-7)


# -- compile cache ------------------------------------------------------------------

def test_compilation_cache_is_the_kernel_build_dir(monkeypatch):
    from ginkgo_tpu_torch.ops import _cuda
    monkeypatch.delenv("GINKGO_TPU_NO_COMPILE_CACHE", raising=False)
    p1 = enable_compilation_cache()
    p2 = enable_compilation_cache(p1)
    assert p1 == p2 == str(_cuda.BUILD_DIR)
    assert p1.endswith("_kernels")
    with pytest.raises(NotSupportedError):
        enable_compilation_cache("/elsewhere")


def test_compilation_cache_opt_out(monkeypatch):
    monkeypatch.setenv("GINKGO_TPU_NO_COMPILE_CACHE", "1")
    assert enable_compilation_cache() is None
