"""The attic SpMV generations (windowed ELL, chunk ELL): the port against
ginkgo_tpu on the same matrices (made with numpy from a seed).

The host planners are verbatim copies, so every planned array, the meta,
the COO tail and the stats must be bit-identical.  The plain versions plus
the tail must match the JAX package's plain versions plus a scipy tail to
the reference tests' 2e-4 at f32 and 1e-12 at f64, and the Pallas kernels
in interpret mode (as the reference tests run them) to 2e-4 at f32.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ginkgo_tpu.base.matrix_data import MatrixData as JMatrixData
from ginkgo_tpu.ops.attic import spmv_chunked as JC
from ginkgo_tpu.ops.attic import spmv_windowed as JW
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.base.matrix_data import MatrixData
from ginkgo_tpu_torch.ops.attic import spmv_chunked as TC
from ginkgo_tpu_torch.ops.attic import spmv_windowed as TW

# (module pair, the planner's name, the apply, the cap that forces a tail)
KINDS = {"windowed": (JW, TW, "plan_windowed_layout", "well_spmv",
                      dict(h_quantile=0.5)),
         "chunked": (JC, TC, "plan_chunked_layout", "cell_spmv",
                     dict(wv_cap=2))}


def _random_local(n, lo_deg, hi_deg, bw, seed=0):
    """The reference tests' banded-ish random matrix: varying degree,
    columns within +-bw."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    for r in range(n):
        deg = rng.integers(lo_deg, hi_deg)
        rows_l.append(np.full(deg, r))
        cols_l.append(np.clip(r + rng.integers(-bw, bw, deg), 0, n - 1))
    key = np.unique(np.concatenate(rows_l) * n + np.concatenate(cols_l))
    rows, cols = key // n, key % n
    return (n, rows.astype(np.int64), cols.astype(np.int64),
            rng.standard_normal(rows.size))


def _fem():
    d = build_matrix_data({"fem": 4096, "offscale": 1.2})
    return (d.shape[0], d.row_idx.astype(np.int64),
            d.col_idx.astype(np.int64), d.values)


CASES = {
    # the three cases of tests/test_attic_kernels.py
    "local_3000": lambda: _random_local(3000, 5, 30, 400, 0),
    "tight_2500": lambda: _random_local(2500, 1, 8, 50, 1),
    "spread_1500": lambda: _random_local(1500, 20, 64, 1400, 2),
    "fem_4096": _fem,
}


def _plan(kind, case, capped=False):
    """Both planners on one matrix: ((layout, tail, stats) of JAX, of the
    port, n, the COO triplets)."""
    jmod, tmod, planner, _, cap = KINDS[kind]
    n, rows, cols, vals = CASES[case]() if isinstance(case, str) else case
    kw = cap if capped else {}
    j = getattr(jmod, planner)(JMatrixData((n, n), rows, cols, vals), vals,
                               **kw)
    t = getattr(tmod, planner)(MatrixData((n, n), rows, cols, vals), vals,
                               **kw)
    return j, t, n, (rows, cols, vals)


@pytest.mark.parametrize("capped", [False, True], ids=["", "capped"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_planners_are_bit_identical(kind, case, capped):
    (jl, jt, js), (tl, tt, ts), _, (rows, cols, vals) = _plan(kind, case,
                                                               capped)
    assert tl["meta"] == jl["meta"]
    assert set(tl) == set(jl)
    for key in tl:
        if key != "meta":
            assert tl[key].dtype == jl[key].dtype, key
            np.testing.assert_array_equal(tl[key], jl[key], err_msg=key)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a, b)
    assert ts == js
    # the tail is the exact complement of the ELL part
    assert ts["ell_nnz"] + ts["tail_nnz"] == vals.size
    keys = set(zip(rows.tolist(), cols.tolist()))
    tail_keys = set(zip(tt[0].tolist(), tt[1].tolist()))
    assert len(tail_keys) == ts["tail_nnz"] and tail_keys <= keys
    if capped:
        assert ts["tail_nnz"] > 0


def _jax_apply(kind, layout, tail, n, b):
    """The JAX package's plain version plus a scipy tail, in b's dtype."""
    jmod, _, _, name, _ = KINDS[kind]
    ref = getattr(jmod, f"{name}_reference")
    arrays = getattr(TW if kind == "windowed" else TC, "ARRAYS")
    args = [jnp.asarray(layout[k]) for k in arrays]
    args[0] = args[0].astype(b.dtype)
    y = np.asarray(ref(*args, layout["meta"], jnp.asarray(b)))
    tr, tc, tv = tail
    return y + sp.csr_matrix((tv, (tr, tc)), shape=(n, n)) @ b


def _port_apply(kind, layout, tail, b):
    """The port's apply on the CPU (its plain version) plus the tail,
    with the planned values in b's dtype."""
    _, tmod, _, name, _ = KINDS[kind]
    t = tmod.upload(dict(layout, vals=layout["vals"].astype(b.dtype)),
                    tail, "cpu")
    before = getattr(tmod, f"{name}_cuda").launches
    y = getattr(tmod, f"{name}_apply")(t, torch.from_numpy(b))
    assert getattr(tmod, f"{name}_cuda").launches == before
    return y.numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
@pytest.mark.parametrize("capped", [False, True], ids=["", "capped"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_plus_tail_matches_jax(kind, case, capped, dtype):
    (_, _, _), (tl, tt, _), n, (rows, cols, vals) = _plan(kind, case,
                                                          capped)
    b = np.random.default_rng(n).standard_normal((n, 3)).astype(dtype)
    tail = (tt[0], tt[1], tt[2].astype(dtype))
    got = _port_apply(kind, tl, tail, b)
    want = _jax_apply(kind, tl, tail, n, b)
    tol = 2e-4 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if dtype == np.float64:
        oracle = sp.csr_matrix((vals, (rows, cols)), shape=(n, n)) @ b
        np.testing.assert_allclose(got, oracle, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_matches_pallas_interpret(kind):
    """A two-superblock matrix (the interpreted kernel takes seconds a
    superblock), planned with the cap that spills to the tail, so the slab
    holds padding slots among live ones: the port's plain version against
    the Pallas kernel."""
    case = _random_local(1200, 3, 12, 1100, 4)
    _, (tl, tt, _), n, _ = _plan(kind, case, capped=True)
    jmod, _, _, name, _ = KINDS[kind]
    b = np.random.default_rng(6).standard_normal((n, 1)).astype(np.float32)
    arrays = TW.ARRAYS if kind == "windowed" else TC.ARRAYS
    args = [jnp.asarray(tl[k]) for k in arrays]
    args[0] = args[0].astype(jnp.float32)
    y_pl = np.asarray(getattr(jmod, f"{name}_pallas")(
        *args, tl["meta"], jnp.asarray(b), interpret=True))
    _, tmod, _, _, _ = KINDS[kind]
    t = tmod.upload(tl, tt, "cpu")
    y = getattr(tmod, f"{name}_reference")(
        *(t[k].float() if k == "vals" else t[k] for k in arrays), t["meta"],
        torch.from_numpy(b))
    np.testing.assert_allclose(y.numpy(), y_pl, rtol=2e-4, atol=2e-4)


def test_attic_is_not_imported_by_the_package():
    code = ("import sys, ginkgo_tpu_torch, ginkgo_tpu_torch.solver, "
            "ginkgo_tpu_torch.ops, ginkgo_tpu_torch.preconditioner, "
            "ginkgo_tpu_torch.factorization, ginkgo_tpu_torch.benchmark; "
            "from ginkgo_tpu_torch.ops import registry; "
            "bad = [m for m in sys.modules if 'attic' in m]; "
            "bad += [k for k in ('well_spmv', 'cell_spmv') "
            "if k in registry._kernels]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors the registered cuda tier is the plain version and
    counts no launch.  Kernels G and H take their slab's compact stream
    (``ops/spmv_sell.py``), so the plain version of both is the stream's,
    which agrees with the slab's own (``well_spmv_reference``,
    ``cell_spmv_reference``)."""
    from ginkgo_tpu_torch.ops import registry, spmv_sell
    case = _random_local(700, 2, 10, 300, 5)
    plain = spmv_sell.sell_spmv_reference
    for kind in KINDS:
        _, (tl, tt, _), n, _ = _plan(kind, case)
        _, tmod, _, name, _ = KINDS[kind]
        t = tmod.upload(dict(tl, vals=tl["vals"].astype(np.float64)), tt,
                        "cpu")
        args = [t["sell"], t["sell_meta"]]
        assert registry.lookup(name, "cpu") is plain
        b = torch.ones((n, 2), dtype=torch.float64)
        before = getattr(tmod, f"{name}_cuda").launches
        y = getattr(tmod, f"{name}_cuda")(*args, b)
        assert getattr(tmod, f"{name}_cuda").launches == before
        assert torch.equal(y, plain(*args, b))
        slab = getattr(tmod, f"{name}_reference")(
            *(t[k] for k in tmod.ARRAYS), t["meta"], b)
        np.testing.assert_allclose(y.numpy(), slab.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(slab.abs().max()))
