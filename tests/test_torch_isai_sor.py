"""ISAI, SOR/SSOR and Gauss-Seidel (``preconditioner/isai.py``,
``preconditioner/sor.py``): the port against ginkgo_tpu on the same
matrices, on the CPU.  ISAI in its four modes through each of its three
block fills (DIA, packed and host; the packed fill forced here, as the
JAX package's tests force it, since it serves only the card): the inverse
to 1e-10 in f64 and 1e-5 in f32.  SOR applies to 1e-12; the
preconditioned CG iteration counts equal the reference's in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
import ginkgo_tpu.preconditioner.isai as jisai
from ginkgo_tpu.preconditioner import GaussSeidel as JGaussSeidel
from ginkgo_tpu.preconditioner import Sor as JSor
from ginkgo_tpu.solver import Cg as JCg
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
import ginkgo_tpu_torch.preconditioner.isai as tisai
from ginkgo_tpu_torch import native
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.preconditioner import GaussSeidel, Isai, Sor
from ginkgo_tpu_torch.solver import Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils import generators as tgen

CPU = torch.device("cpu")
MODES = ["general", "lower", "upper", "spd"]
FILLS = ["dia", "packed", "host"]
TOL = {np.float64: 1e-10, np.float32: 1e-5}


def _j(d):
    return gt.MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


def _both(d, dtype=np.float64):
    return (gtt.Csr.from_data(d, dtype=dtype, device="cpu"),
            gt.Csr.from_data(_j(d), dtype=dtype))


def _force(monkeypatch, fill):
    """Route both packages' generates to ``fill``: the DIA fill is taken
    by pattern, the packed fill by device (forced), the host fill when
    neither is."""
    packed = fill == "packed"
    monkeypatch.setattr(tisai, "_want_packed_fill", lambda *a: packed)
    monkeypatch.setattr(jisai, "_want_packed_fill", lambda *a: packed)
    if fill != "dia":
        monkeypatch.setattr(tisai, "_dia_fits", lambda *a: False)
        monkeypatch.setattr(jisai, "_isai_fill_dia", lambda *a, **k: None)


def _inverses(M):
    return (M.linv, M.linv_h) if isinstance(M, tisai.SpdIsai) else (M,)


def _jinverses(Mj):
    return (Mj.linv, Mj.linv_h) if isinstance(Mj, jisai.SpdIsai) else (Mj,)


def _same_inverse(M, Mj, rtol):
    for got, want in zip(_inverses(M), _jinverses(Mj)):
        assert got.device == CPU
        g, w = got.to_matrix_data(), want.to_matrix_data()
        assert np.array_equal(g.row_idx, w.row_idx)
        assert np.array_equal(g.col_idx, w.col_idx)
        np.testing.assert_allclose(g.values, w.values, rtol=rtol,
                                   atol=rtol * np.abs(w.values).max())
        assert got.strategy == want.strategy


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("mode", MODES)
def test_isai_matches_jax(mode, fill, dtype, monkeypatch):
    d = tgen.stencil_3d(6, points=27)
    A, Aj = _both(d, dtype)
    _force(monkeypatch, fill)
    tisai._ISAI_SYM_CACHE.clear()
    assert tisai.isai_route(A, 1, "lower" if mode == "spd" else mode) \
        == fill
    M, Mj = Isai(mode=mode).generate(A), jisai.Isai(mode=mode).generate(Aj)
    _same_inverse(M, Mj, TOL[dtype])
    b = np.random.default_rng(1).standard_normal(A.shape[0]).astype(dtype)
    y = M.apply(torch.from_numpy(b)).numpy()
    yj = np.asarray(Mj.apply(jnp.asarray(b)))
    np.testing.assert_allclose(y, yj, rtol=TOL[dtype],
                               atol=TOL[dtype] * np.abs(yj).max())


@pytest.mark.parametrize("case", ["fem-general", "fem-lower", "power2"])
def test_isai_unstructured_and_powers_match_jax(case):
    """Patterns the DIA fill declines (the FEM matrix) take the host fill
    on the CPU; sparsity power 2 goes through ``spgemm_data``."""
    if case == "power2":
        d, mode, power = tgen.stencil_2d(10, points=5), "general", 2
    else:
        d = build_matrix_data({"fem": 700, "offscale": 1.2})
        mode, power = case.split("-")[1], 1
    A, Aj = _both(d)
    if case != "power2":
        assert tisai.isai_route(A, power, mode) == "host"
    M = tisai.generate_isai(A, power, mode)
    Mj = jisai.generate_isai(Aj, power, mode)
    _same_inverse(M, Mj, 1e-10)


@pytest.mark.parametrize("fill", ["packed", "host"])
def test_isai_fills_without_native(fill, monkeypatch):
    """Without the native library the packed symbolics and the host fill
    take their numpy pair lists: the same inverse."""
    d = build_matrix_data({"fem": 600, "offscale": 1.2})
    A, _ = _both(d)
    _force(monkeypatch, fill)
    tisai._ISAI_SYM_CACHE.clear()
    want = tisai.generate_isai(A, 1, "general")
    monkeypatch.setattr(native, "lib", lambda: None)
    tisai._ISAI_SYM_CACHE.clear()
    got = tisai.generate_isai(A, 1, "general")
    _same_inverse(got, want, 1e-12)


def test_isai_packed_symbolics_are_cached(monkeypatch):
    d = build_matrix_data({"fem": 600, "offscale": 1.2})
    A, _ = _both(d)
    _force(monkeypatch, "packed")
    tisai._ISAI_SYM_CACHE.clear()
    first = tisai.generate_isai(A, 1, "lower")
    calls = []
    real = tisai._isai_packed_symbolics
    monkeypatch.setattr(tisai, "_isai_packed_symbolics",
                        lambda *a: calls.append(1) or real(*a))
    again = tisai.generate_isai(A.scale(2.0), 1, "lower")
    assert calls == []                      # the pattern's symbolics reused
    np.testing.assert_allclose(again.values.numpy(),
                               first.values.numpy() / 2.0, rtol=1e-14)


def test_isai_routes_by_device():
    d = build_matrix_data({"fem": 16384, "offscale": 1.2})
    assert tisai._want_packed_fill(16384, 32, 4, torch.device("cuda"))
    assert not tisai._want_packed_fill(16384, 32, 4, CPU)
    assert not tisai._want_packed_fill(16383, 32, 4, torch.device("cuda"))
    assert not tisai._want_packed_fill(1 << 20, 60, 4, torch.device("cuda"))
    A = gtt.Csr.from_data(d, device="cpu")
    assert tisai.isai_route(A) == "host"
    S = gtt.Csr.from_data(tgen.stencil_3d(6, points=27), device="cpu")
    assert tisai.isai_route(S) == "dia"
    with pytest.raises(ValueError, match="unknown ISAI mode"):
        Isai(mode="both")


SOR_CASES = [
    ("sor", lambda: Sor(relaxation_factor=1.3),
     lambda: JSor(relaxation_factor=1.3)),
    ("ssor", lambda: Sor(relaxation_factor=1.2, symmetric=True),
     lambda: JSor(relaxation_factor=1.2, symmetric=True)),
    ("gs", GaussSeidel, JGaussSeidel),
    ("sgs", lambda: GaussSeidel(symmetric=True),
     lambda: JGaussSeidel(symmetric=True)),
]


@pytest.mark.parametrize("mat", ["fem", "stencil"])
@pytest.mark.parametrize("name,make,jmake", SOR_CASES,
                         ids=[c[0] for c in SOR_CASES])
def test_sor_apply_matches_jax(name, make, jmake, mat):
    d = (build_matrix_data({"fem": 800, "offscale": 1.2}) if mat == "fem"
         else tgen.stencil_3d(7, points=7))
    A, Aj = _both(d)
    M, Mj = make().generate(A), jmake().generate(Aj)
    b = np.random.default_rng(2).standard_normal((A.shape[0], 2))
    y = M.apply(torch.from_numpy(b)).numpy()
    yj = np.asarray(Mj.apply(jnp.asarray(b)))
    np.testing.assert_allclose(y, yj, rtol=1e-12,
                               atol=1e-12 * np.abs(yj).max())
    if name in ("ssor", "sgs"):
        assert M.diag.device == CPU
        assert M.scale == pytest.approx(Mj.scale, rel=1e-15)


def test_sor_matches_its_formula():
    d = tgen.make_spd(tgen.generate_random_matrix(
        15, 15, nonzeros_per_row=(2, 5), seed=10), shift=1.0)
    dense = d.to_dense()
    A = gtt.Csr.from_data(d, device="cpu")
    w = 1.2
    D, L, U = np.diag(np.diag(dense)), np.tril(dense, -1), np.triu(dense, 1)
    b = np.random.default_rng(11).standard_normal(15)
    fwd = Sor(relaxation_factor=w).generate(A).apply(torch.from_numpy(b))
    np.testing.assert_allclose(fwd.numpy(), np.linalg.solve(D / w + L, b),
                               rtol=1e-10)
    M = w / (2 - w) * (D / w + L) @ np.linalg.inv(D) @ (D / w + U)
    sym = Sor(relaxation_factor=w, symmetric=True).generate(A)
    np.testing.assert_allclose(sym.apply(torch.from_numpy(b)).numpy(),
                               np.linalg.solve(M, b), rtol=1e-10)
    with pytest.raises(ValueError, match="relaxation_factor"):
        Sor(relaxation_factor=2.5)


PCG_CASES = [
    ("isai-spd", lambda: Isai(mode="spd"), lambda: jisai.Isai(mode="spd")),
    ("isai-general", Isai, jisai.Isai),
    ("ssor", lambda: Sor(relaxation_factor=1.5, symmetric=True),
     lambda: JSor(relaxation_factor=1.5, symmetric=True)),
]


@pytest.mark.parametrize("name,make,jmake", PCG_CASES,
                         ids=[c[0] for c in PCG_CASES])
def test_preconditioned_cg_iterations_match_jax(name, make, jmake):
    d = tgen.stencil_3d(8, points=7)
    A, Aj = _both(d)
    b = np.stack([np.ones(A.shape[0]),
                  np.random.default_rng(3).standard_normal(A.shape[0])], 1)
    rj = JCg.solve(Aj, jnp.asarray(b), preconditioner=jmake().generate(Aj),
                   criteria=JIteration(500) | JResidualNorm(1e-10))
    rt = Cg.solve(A, torch.from_numpy(b), preconditioner=make().generate(A),
                  criteria=Iteration(500) | ResidualNorm(1e-10))
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    assert bool(rt.converged.all())
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10,
                               atol=1e-10 * float(np.abs(rj.x).max()))
