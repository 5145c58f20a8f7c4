"""The port's small operators against ginkgo_tpu's on the same inputs:
``Permutation``, ``ScaledPermutation``, ``permute_mode`` and the host
remaps ``permute_data``/``scale_permute_data``, ``RowGatherer``,
``CsrLookup``, ``Fft``/``Fft2``/``Fft3``/``FftNd``, and the composites
``Composition``, ``Combination``, ``Perturbation``, ``BlockOperator``.

Index results must be equal exactly; f64 applies agree to 1e-12 relative
to the largest |y|, the FFTs to 1e-12 in complex128 and 1e-5 in
complex64 (both packages call a library FFT).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.base.composition import Composition as JComposition
from ginkgo_tpu.matrix import permutation as jperm
from ginkgo_tpu.matrix.csr_lookup import CsrLookup as JCsrLookup
from ginkgo_tpu_torch.base.composition import Composition
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.matrix import permutation as tperm
from ginkgo_tpu_torch.matrix.csr_lookup import CsrLookup
from ginkgo_tpu_torch.utils import generators as tgen


def jdata(d):
    return gt.MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


def close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    assert np.abs(got - want).max() / scale <= rtol


def rand(shape, seed=0, complex_=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if complex_:
        x = x + 1j * rng.standard_normal(shape)
    return x


def test_permute_mode_is_the_jax_enum():
    assert [m.name for m in tperm.permute_mode] == \
        [m.name for m in jperm.permute_mode]
    for m in tperm.permute_mode:
        assert m.value == jperm.permute_mode[m.name].value


@pytest.mark.parametrize("k", [1, 3])
def test_permutation_matches_jax(k):
    rng = np.random.default_rng(3)
    perm = rng.permutation(50)
    P = gtt.Permutation.from_indices(perm, device="cpu")
    Pj = gt.Permutation.from_indices(perm)
    b = rand((50, k)) if k > 1 else rand(50)
    bt = torch.from_numpy(b)
    for got, want in ((P.apply(bt), Pj.apply(jnp.asarray(b))),
                      (P.inverse().apply(bt),
                       Pj.inverse().apply(jnp.asarray(b))),
                      (P.transpose().apply(bt),
                       Pj.transpose().apply(jnp.asarray(b))),
                      (P.conj_transpose().apply(bt),
                       Pj.conj_transpose().apply(jnp.asarray(b)))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(P.inverse().perm.numpy(),
                          np.asarray(Pj.inverse().perm))
    assert P.perm.dtype == torch.int32 and P.shape == (50, 50)
    np.testing.assert_array_equal(P.to_dense().numpy(),
                                  np.asarray(Pj.to_dense()))
    np.testing.assert_array_equal(P.inverse().apply(P.apply(bt)).numpy(), b)


def test_scaled_permutation_matches_jax():
    rng = np.random.default_rng(4)
    perm, scale = rng.permutation(40), rng.uniform(0.5, 2.0, 40)
    S = gtt.ScaledPermutation.from_indices(perm, scale, device="cpu")
    Sj = gt.ScaledPermutation.from_indices(perm, scale)
    b = rand((40, 2))
    close(S.apply(torch.from_numpy(b)).numpy(),
          np.asarray(Sj.apply(jnp.asarray(b))), 1e-15)
    inv, invj = S.inverse(), Sj.inverse()
    assert np.array_equal(inv.perm.numpy(), np.asarray(invj.perm))
    close(inv.scale.numpy(), np.asarray(invj.scale), 1e-15)
    close(inv.apply(S.apply(torch.from_numpy(b))).numpy(), b, 1e-14)
    np.testing.assert_array_equal(S.to_dense().numpy(),
                                  np.asarray(Sj.to_dense()))


MODES = ["rows", "columns", "symmetric", "inverse_rows", "inverse_columns",
         "inverse_symmetric"]


@pytest.mark.parametrize("mode", MODES)
def test_host_remaps_match_jax(mode):
    d = tgen.generate_random_matrix(30, 30, nonzeros_per_row=(1, 6), seed=9)
    rng = np.random.default_rng(10)
    perm, scale = rng.permutation(30), rng.uniform(0.5, 2.0, 30)
    pairs = [(tperm.permute_data(d, perm, tperm.permute_mode[mode]),
              jperm.permute_data(jdata(d), perm, jperm.permute_mode[mode])),
             (tperm.scale_permute_data(d, (perm, scale),
                                       tperm.permute_mode[mode]),
              jperm.scale_permute_data(jdata(d), (perm, scale),
                                       jperm.permute_mode[mode]))]
    for got, want in pairs:
        for name in ("row_idx", "col_idx", "values"):
            assert np.array_equal(getattr(got, name),
                                  np.asarray(getattr(want, name))), name
    with pytest.raises(ValueError, match="not both"):
        tperm.scale_permute_data(d, (perm, scale),
                                 tperm.permute_mode[mode],
                                 col_sp=(perm, scale))


def test_csr_permute_agrees_with_permutations_on_both_sides():
    """P A P^T applied to b equals Csr.permute(perm) applied to b, on the
    banded and the packed pattern."""
    for d in (tgen.stencil_3d(8, points=27),
              build_matrix_data({"fem": 4096})):
        n = d.shape[0]
        perm = np.random.default_rng(12).permutation(n)
        A = gtt.Csr.from_data(d, device="cpu")
        B = A.permute(perm)
        P = gtt.Permutation.from_indices(perm, device="cpu")
        b = torch.from_numpy(rand((n, 2), seed=13))
        want = P.apply(A.apply(P.inverse().apply(b)))
        close(B.apply(b).numpy(), want.numpy(), 1e-12)
        dense = A.to_dense().numpy()
        np.testing.assert_array_equal(B.to_dense().numpy(),
                                      dense[np.ix_(perm, perm)])


def test_row_gatherer_matches_jax():
    rows = [3, 1, 4, 1, 5, 9, 2, 6]
    G = gtt.RowGatherer.from_indices(rows, num_cols=10, device="cpu")
    Gj = gt.RowGatherer.from_indices(rows, num_cols=10)
    b, x = rand((10, 2)), rand((8, 2), seed=1)
    assert G.shape == Gj.shape == (8, 10)
    assert np.array_equal(G.apply(torch.from_numpy(b)).numpy(),
                          np.asarray(Gj.apply(jnp.asarray(b))))
    close(G.apply_advanced(2.0, torch.from_numpy(b), -1.0,
                           torch.from_numpy(x)).numpy(),
          np.asarray(Gj.apply_advanced(2.0, jnp.asarray(b), -1.0,
                                       jnp.asarray(x))), 1e-15)


@pytest.mark.parametrize("case", ["stencil", "fem", "rect"])
def test_csr_lookup_matches_jax(case):
    d = {"stencil": lambda: tgen.stencil_3d(6, points=27),
         "fem": lambda: build_matrix_data({"fem": 2048}),
         "rect": lambda: tgen.generate_random_matrix(
             40, 25, nonzeros_per_row=(0, 6), seed=2)}[case]()
    A = gtt.Csr.from_data(d, device="cpu")
    L = CsrLookup.build(A)
    Lj = JCsrLookup.build(gt.Csr.from_data(jdata(d)))
    for name in ("cols_padded", "base", "lengths"):
        assert np.array_equal(getattr(L, name).numpy(),
                              np.asarray(getattr(Lj, name))), name
    rng = np.random.default_rng(7)
    n, m = d.shape
    rows, cols = rng.integers(0, n, 5000), rng.integers(0, m, 5000)
    dc = d.canonical()
    # half the queries hit stored entries
    hit = rng.integers(0, dc.nnz, 2500)
    rows[:2500], cols[:2500] = dc.row_idx[hit], dc.col_idx[hit]
    got = L.lookup(rows, cols).numpy()
    assert np.array_equal(got, np.asarray(Lj.lookup(rows, cols)))
    assert np.array_equal(got[:2500], hit)
    vals = A.values.numpy()
    found = got >= 0
    dense = dc.to_dense()
    np.testing.assert_array_equal(vals[got[found]],
                                  dense[rows[found], cols[found]])
    assert np.all(dense[rows[~found], cols[~found]] == 0)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32],
                         ids=["f64", "c128", "f32"])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_matches_jax(inverse, dtype):
    b = rand((16, 2), complex_=np.dtype(dtype).kind == "c").astype(dtype)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    for F, Fj in ((gtt.Fft(16, inverse=inverse),
                   gt.Fft(size=16, inverse=inverse)),
                  (gtt.Fft2(4, 4, inverse=inverse),
                   gt.Fft2(4, 4, inverse=inverse)),
                  (gtt.FftNd((2, 4, 2), inverse=inverse),
                   gt.FftNd(dims=(2, 4, 2), inverse=inverse))):
        got = F.apply(torch.from_numpy(b))
        want = np.asarray(Fj.apply(jnp.asarray(b)))
        assert got.dtype == (torch.complex64 if dtype == np.float32
                             else torch.complex128)
        close(got.numpy(), want, tol)
        adj, adjj = F.conj_transpose(), Fj.conj_transpose()
        assert adj.scale == adjj.scale and adj.inverse == adjj.inverse
        close(adj.apply(got).numpy(),
              np.asarray(adjj.apply(jnp.asarray(want))), tol)
    assert gtt.Fft(16).transpose().shape == (16, 16)


def test_fft3_against_numpy():
    rng = np.random.default_rng(6)
    grid = rng.standard_normal((6, 5, 4)) + 1j * rng.standard_normal(
        (6, 5, 4))
    F = gtt.Fft3(6, 5, 4)
    out = F.apply(torch.from_numpy(grid.ravel()))
    close(out.numpy(), np.fft.fftn(grid).ravel(), 1e-12)
    back = gtt.Fft3(6, 5, 4, inverse=True).apply(out)
    close(back.numpy(), grid.ravel(), 1e-12)
    assert gtt.Fft3(7).dims == (7, 7, 7) and gtt.Fft2(3).dims == (3, 3)


def test_composites_match_jax():
    d1 = tgen.generate_random_matrix(12, 12, nonzeros_per_row=(1, 4),
                                     seed=12)
    d2 = tgen.generate_random_matrix(12, 12, nonzeros_per_row=(1, 4),
                                     seed=13)
    d3 = tgen.generate_random_matrix(12, 5, nonzeros_per_row=(1, 3), seed=14)
    d4 = tgen.generate_random_matrix(5, 12, nonzeros_per_row=(1, 3), seed=15)
    A, B, U, V = (gtt.Csr.from_data(d, device="cpu")
                  for d in (d1, d2, d3, d4))
    Aj, Bj, Uj, Vj = (gt.Csr.from_data(jdata(d)) for d in (d1, d2, d3, d4))
    b = rand((12, 2))
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    pairs = [
        (Composition((A, B)), JComposition(ops=(Aj, Bj))),
        (A @ B, Aj @ Bj),
        (gtt.Combination((2.0, -1.0), (A, B)),
         gt.Combination(coefficients=(2.0, -1.0), operators=(Aj, Bj))),
        (gtt.Perturbation(0.5, U, V),
         gt.Perturbation(scalar=0.5, basis=Uj, projector=Vj)),
    ]
    for mine, theirs in pairs:
        assert mine.shape == theirs.shape
        close(mine.apply(bt).numpy(), np.asarray(theirs.apply(bj)), 1e-12)
    blocks = ((A, U), (V, None))
    Bo = gtt.BlockOperator(blocks)
    Boj = gt.BlockOperator(blocks=((Aj, Uj), (Vj, None)))
    assert Bo.shape == Boj.shape == (17, 17)
    b2 = rand((17, 3), seed=2)
    close(Bo.apply(torch.from_numpy(b2)).numpy(),
          np.asarray(Boj.apply(jnp.asarray(b2))), 1e-12)
    np.testing.assert_allclose(Bo.to_dense().numpy(),
                               np.asarray(Boj.to_dense()), rtol=1e-14)
    with pytest.raises(ValueError, match="non-conformant"):
        Composition((A, V))
