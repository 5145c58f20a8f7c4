"""Reorderings (``reorder/``): the port against ginkgo_tpu on the same
matrices, on the CPU.  Every ordering must be the reference's index for
index (the same host code and the same native source); MC64's scalings
to 1e-15; ScaledReordered solves to 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu import reorder as jreorder
from ginkgo_tpu.factorization.direct import Lu as JLu
from ginkgo_tpu.reorder import amd as jamd
from ginkgo_tpu.reorder import nested_dissection as jnd
from ginkgo_tpu.solver.direct import Direct as JDirect
from ginkgo_tpu_torch import native
from ginkgo_tpu_torch import reorder
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.factorization import Cholesky
from ginkgo_tpu_torch.reorder import amd, nested_dissection
from ginkgo_tpu_torch.solver import Direct
from ginkgo_tpu_torch.utils import generators as tgen

CPU = torch.device("cpu")

MATRICES = {
    "stencil2d": lambda: tgen.stencil_2d(12, points=5),
    "stencil3d": lambda: tgen.stencil_3d(7, points=27),
    "fem": lambda: build_matrix_data({"fem": 1500, "offscale": 1.2}),
    "random": lambda: tgen.generate_random_matrix(
        300, 300, nonzeros_per_row=(2, 7), seed=4, ensure_diag=True),
}
ORDERINGS = ["Rcm", "Amd", "NestedDissection", "Mc64"]


def _j(d):
    return gt.MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


@pytest.mark.parametrize("name", ORDERINGS)
@pytest.mark.parametrize("mat", list(MATRICES))
def test_ordering_equals_jax_index_for_index(name, mat):
    d = MATRICES[mat]()
    A = gtt.Csr.from_data(d, device="cpu")
    P = getattr(reorder, name).build().generate(A)
    Pj = getattr(jreorder, name).build().generate(gt.Csr.from_data(_j(d)))
    perm = P.perm.numpy() if isinstance(P.perm, torch.Tensor) else P.perm
    assert np.array_equal(perm, np.asarray(Pj.perm))
    assert np.array_equal(np.sort(perm), np.arange(d.shape[0]))
    if name == "Mc64":
        np.testing.assert_allclose(P.scale, Pj.scale, rtol=1e-15)
        np.testing.assert_allclose(P.col_scale, Pj.col_scale, rtol=1e-15)
        row, col = P.unpack()
        assert row.perm.device == col.scale.device == CPU
    else:
        assert P.perm.device == CPU


def test_orderings_of_matrix_data_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = tgen.stencil_2d(4)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        reorder.Rcm().generate(d)
    P = reorder.Amd().generate(gtt.Csr.from_data(d, device="cpu"))
    assert P.perm.device == CPU


def test_python_fallbacks_without_native(monkeypatch):
    """Without the native library AMD takes exact minimum degree and ND
    recursive BFS bisection, each the reference's fallback index for
    index; MC64's Python SAP gives the native matching."""
    d = tgen.stencil_2d(9, points=5)
    want_mc64 = reorder.mc64_matching(d)
    monkeypatch.setattr(native, "lib", lambda: None)
    assert np.array_equal(amd.amd_ordering(d),
                          jamd._md_ordering_python(_j(d).canonical()))
    assert np.array_equal(
        nested_dissection.nested_dissection_ordering(d, 8),
        jnd._nested_dissection_python(_j(d), 8))
    got = reorder.mc64_matching(d)
    assert np.array_equal(got[0], want_mc64[0])
    np.testing.assert_allclose(got[1], want_mc64[1], rtol=1e-12)
    np.testing.assert_allclose(got[2], want_mc64[2], rtol=1e-12)


def test_mc64_scaling_guarantees():
    rng = np.random.default_rng(3)
    n, deg = 2000, 6
    r = np.concatenate([np.repeat(np.arange(n), deg), np.arange(n)])
    c = np.concatenate([rng.integers(0, n, n * deg), np.arange(n)])
    v = np.concatenate([rng.uniform(0.5, 2.0, n * deg),
                        rng.uniform(1e-8, 1e-6, n)])
    key, idx = np.unique(r * n + c, return_index=True)
    d = gtt.MatrixData((n, n), key // n, key % n, v[idx])
    perm, rs, cs = reorder.mc64_matching(d)
    jperm, jrs, jcs = jreorder.mc64_matching(_j(d))
    assert np.array_equal(perm, jperm)
    np.testing.assert_allclose(rs, jrs, rtol=1e-15)
    B = np.zeros((n, n))
    B[d.row_idx, d.col_idx] = d.values
    B = rs[:, None] * B[perm] * cs[None, :]
    assert np.abs(B).max() <= 1 + 1e-6
    assert np.abs(np.abs(np.diagonal(B)) - 1).max() < 1e-6


def test_amd_reduces_fill():
    d = tgen.stencil_2d(10, points=5)
    A = gtt.Csr.from_data(d, device="cpu")
    B = A.permute(reorder.Amd().generate(A).perm)
    bad = np.argsort(reorder.rcm_ordering(d))
    fill = Cholesky().generate(B).l_factor.nnz
    assert fill <= Cholesky().generate(A.permute(bad)).l_factor.nnz


def _mc64_case():
    rng = np.random.default_rng(7)
    n = 12
    dense = rng.standard_normal((n, n)) * (rng.uniform(size=(n, n)) < 0.5)
    dense[np.arange(n), np.arange(n)] = 1e-14
    dense[0, :] += 1.0
    dense += np.roll(np.eye(n) * 3.0, 1, axis=1)
    return dense


@pytest.mark.parametrize("name", ["Rcm", "Mc64", "NestedDissection"])
def test_scaled_reordered_direct_matches_jax(name):
    if name == "Mc64":
        dense = _mc64_case()
        d = gtt.MatrixData.from_dense(dense)
    else:
        d = tgen.make_spd(tgen.generate_random_matrix(
            30, 30, nonzeros_per_row=(2, 5), seed=8), shift=1.0)
        dense = d.to_dense()
    n = d.shape[0]
    x_true = np.random.default_rng(9).standard_normal((n, 2))
    b = dense @ x_true
    A = gtt.Csr.from_data(d, device="cpu")
    op = reorder.ScaledReordered(inner_operator=Direct(),
                                 reordering=getattr(reorder, name)()
                                 ).generate(A)
    jop = jreorder.ScaledReordered(
        inner_operator=JDirect(factorization=JLu()),
        reordering=getattr(jreorder, name)()).generate(gt.Csr.from_data(
            _j(d)))
    x = op.apply(torch.from_numpy(b)).numpy()
    xj = np.asarray(jop.apply(jnp.asarray(b)))
    assert op.shape == (n, n) and op.perm.perm.device == CPU
    np.testing.assert_allclose(x, xj, rtol=1e-10, atol=1e-12)
    resid = np.abs(dense @ x - b).max() / np.abs(b).max()
    assert resid <= 1e-10


def test_scaled_reordered_defaults_to_rcm():
    d = tgen.stencil_2d(6)
    A = gtt.Csr.from_data(d, device="cpu")
    op = reorder.ScaledReordered(inner_operator=Direct()).generate(A)
    assert np.array_equal(op.perm.perm.numpy(), reorder.rcm_ordering(d))
    b = np.ones(36)
    x = op.apply(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(d.to_dense() @ x, b, rtol=1e-10)
