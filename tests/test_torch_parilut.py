"""ParILUT / ParICT (``factorization/par_ilut*.py``): the port against
ginkgo_tpu on the same inputs, in f64 on the CPU.

The packed plans must equal the JAX package's array for array; packed and
host-path factors must have identical patterns and values within 1e-10
(relative to max |value|: sums in another order); solves must take the
same iterations.  ParICT runs on symmetric matrices: on a nonsymmetric
one its square roots of clamped negative pivots amplify rounding from one
iteration to the next (1e-13 after the init sweeps, 1e-8 after three
iterations on the nonsymmetric FEM case), in both packages alike."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.factorization import par_ilut as jpi
from ginkgo_tpu.factorization import par_ilut_dia as jdia
from ginkgo_tpu.factorization import par_ilut_packed as jpk
from ginkgo_tpu.ops.registry import use_tier as juse_tier
from ginkgo_tpu.preconditioner import Ilu as JIlu
from ginkgo_tpu.solver import Bicgstab as JBicgstab
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu_torch.base.matrix_data import MatrixData
from ginkgo_tpu_torch.benchmark import build_matrix_data
from ginkgo_tpu_torch.factorization import ParIct, ParIlut
from ginkgo_tpu_torch.factorization import par_ilut as tpi
from ginkgo_tpu_torch.factorization import par_ilut_dia as tdia
from ginkgo_tpu_torch.factorization import par_ilut_packed as pk
from ginkgo_tpu_torch.ops import pair_contract as pc
from ginkgo_tpu_torch.ops.registry import use_tier
from ginkgo_tpu_torch.preconditioner import Ilu
from ginkgo_tpu_torch.solver import Bicgstab
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils import stagetimer
from ginkgo_tpu_torch.utils.generators import (random_banded, stencil_3d,
                                               symmetric_part)


# the JAX package's test helper (tests/test_parilut_packed.py::_banded_random)
_banded_random = random_banded
_symmetric = symmetric_part


def test_generator_is_the_jax_test_helper():
    from test_parilut_packed import _banded_random as jax_helper
    for args in ((600, 12, 6, 3), (800, 10, 5, 5)):
        a, b = random_banded(*args[:3], seed=args[3]), jax_helper(
            *args[:3], seed=args[3])
        for name in ("row_idx", "col_idx", "values"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def _jdata(d):
    return gt.MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


def _both(d):
    return gtt.Csr.from_data(d, device="cpu"), gt.Csr.from_data(_jdata(d))


def _assert_factor_equal(port_op, jax_op, rtol=1e-10):
    a, b = port_op.to_matrix_data(), jax_op.to_matrix_data()
    assert a.shape == b.shape
    assert np.array_equal(a.row_idx, b.row_idx)
    assert np.array_equal(a.col_idx, b.col_idx)
    assert a.values.dtype == np.asarray(b.values).dtype
    np.testing.assert_allclose(a.values, b.values, rtol=rtol,
                               atol=rtol * np.abs(b.values).max())


def _assert_same_factors(F, Fj):
    assert F.symmetric == Fj.symmetric
    _assert_factor_equal(F.l_factor, Fj.l_factor)
    _assert_factor_equal(F.u_factor, Fj.u_factor)
    assert F.l_factor.device.type == "cpu"


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def _assert_contract_plans_equal(p, q):
    assert p["n_out"] == q["n_out"]
    for a, b in zip(p["raw"], q["raw"]):
        np.testing.assert_array_equal(a, b)
    assert (p["kernel"] is None) == (q["kernel"] is None)
    if p["kernel"] is None:
        return
    k, kj = p["kernel"], q["kernel"]
    assert k["meta"] == kj["meta"] and k["fill"] == kj["fill"]
    for name in ("pls", "pus", "pos", "pes", "pesp", "lq", "uq", "nv",
                 "lbase", "ubase"):
        np.testing.assert_array_equal(k[name], kj[name], err_msg=name)
    for a, b in zip(k["tail"], kj["tail"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tier", ["reference", "kernel"])
@pytest.mark.parametrize("kind", ["ilut", "ict"])
def test_plan_packed_matches_jax(kind, tier):
    d = _banded_random(800, 10, 5, seed=5)
    if kind == "ict":
        d = _symmetric(d)
    planner, jplanner = ((pk.plan_packed_ilut, jpk.plan_packed_ilut)
                         if kind == "ilut" else
                         (pk.plan_packed_ict, jpk.plan_packed_ict))
    with use_tier("cuda" if tier == "kernel" else "reference"), \
            juse_tier("tpu" if tier == "kernel" else "reference"):
        p = planner(d, level=3, fill_in_limit=2.0)
        q = jplanner(_jdata(d), level=3, fill_in_limit=2.0)
    assert set(p) == set(q)
    for name in p:
        if name in ("prod", "den"):
            _assert_contract_plans_equal(p[name], q[name])
            assert (p[name]["kernel"] is None) == (tier == "reference")
        elif isinstance(p[name], tuple):
            for a, b in zip(p[name], q[name]):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(p[name], q[name])


def test_symbolic_estimates_match_jax():
    import scipy.sparse as sp
    d = _banded_random(4000, 30, 8, seed=4)
    n = d.shape[0]
    rows, cols = pk._closure(d, 2, 40_000_000)
    jrows, jcols = jpk._closure(_jdata(d), 2, 40_000_000)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(cols, jcols)
    assert pk._estimate_ilut_pairs(n, rows, cols) == \
        jpk._estimate_ilut_pairs(n, rows, cols)
    P = sp.csr_matrix((np.ones(d.nnz, np.float32),
                       (d.row_idx, d.col_idx)), shape=(n, n))
    for lower in (False, True):
        Q = sp.tril(P, 0, format="csr") if lower else P
        assert pk._estimate_closure_nnz(Q, lower) == \
            jpk._estimate_closure_nnz(Q, lower)
    assert pk.plan_packed_ilut(d, max_pairs=10) is None


# ---------------------------------------------------------------------------
# factors
# ---------------------------------------------------------------------------

PACKED = [
    ("ilut-banded", ParIlut, jpi.ParIlut,
     lambda: _banded_random(600, 12, 6, seed=3), dict(fill_in_limit=1.5)),
    ("ilut-fem", ParIlut, jpi.ParIlut,
     lambda: build_matrix_data({"fem": 2048, "offscale": 1.2}), {}),
    ("ilut-complex", ParIlut, jpi.ParIlut,
     lambda: _complex(_banded_random(500, 9, 5, seed=13)), {}),
    ("ict-banded", ParIct, jpi.ParIct,
     lambda: _symmetric(_banded_random(800, 10, 5, seed=5)), {}),
    ("ict-fem", ParIct, jpi.ParIct,
     lambda: build_matrix_data({"fem": 2048, "sym": True}), {}),
]


def _complex(d):
    rng = np.random.default_rng(2)
    return MatrixData(d.shape, d.row_idx, d.col_idx,
                      d.values + 0.05j * rng.standard_normal(d.nnz))


@pytest.mark.parametrize("case", PACKED, ids=[c[0] for c in PACKED])
def test_packed_factors_match_jax(case, monkeypatch):
    _, P, JP, data, kw = case
    d = data()
    A, Aj = _both(d)
    ran = []
    for name in ("generate_packed", "generate_packed_ict"):
        real = getattr(pk, name)
        monkeypatch.setattr(pk, name, lambda *a, _real=real, **k:
                            ran.append(_real(*a, **k)) or ran[-1])
    F = P(iterations=3, algorithm="packed", **kw).generate(A)
    assert len(ran) == 1 and ran[0] is not None    # the packed path ran
    Fj = JP(iterations=3, algorithm="packed", **kw).generate(Aj)
    _assert_same_factors(F, Fj)


def test_packed_respects_fill_limit():
    d = _banded_random(600, 12, 6, seed=3)
    f = ParIlut(iterations=3, fill_in_limit=1.5,
                algorithm="packed").generate(gtt.Csr.from_data(d,
                                                               device="cpu"))
    total = f.l_factor.nnz + f.u_factor.nnz
    assert total <= 1.5 * d.nnz + d.shape[0] + 2
    fi = ParIct(iterations=3, fill_in_limit=1.5, algorithm="packed").generate(
        gtt.Csr.from_data(_symmetric(d), device="cpu"))
    low = int((_symmetric(d).row_idx >= _symmetric(d).col_idx).sum())
    assert fi.l_factor.nnz <= int(np.ceil(1.5 * low)) + 2


GENERAL = [
    ("ilut-host", lambda: ParIlut(iterations=3, algorithm="general"),
     lambda: jpi.ParIlut(iterations=3, algorithm="general"),
     lambda: build_matrix_data({"fem": 1024, "offscale": 1.2})),
    ("ilut-device-sweeps",
     lambda: ParIlut(iterations=2, sweep_mode="device", algorithm="general"),
     lambda: jpi.ParIlut(iterations=2, sweep_mode="device",
                         algorithm="general"),
     lambda: _banded_random(500, 9, 5, seed=13)),
    ("ilut-dia-declined", lambda: ParIlut(iterations=2, algorithm="dia"),
     lambda: jpi.ParIlut(iterations=2, algorithm="dia"),
     lambda: _banded_random(300, 40, 4, seed=2)),
    ("ict-host", lambda: ParIct(iterations=3, algorithm="general"),
     lambda: jpi.ParIct(iterations=3, algorithm="general"),
     lambda: _symmetric(_banded_random(700, 15, 6, seed=9))),
]


@pytest.mark.parametrize("case", GENERAL, ids=[c[0] for c in GENERAL])
def test_general_path_matches_jax(case):
    _, make, jmake, data = case
    A, Aj = _both(data())
    _assert_same_factors(make().generate(A), jmake().generate(Aj))


def test_auto_routes_like_jax(monkeypatch):
    """On the CPU ``auto`` takes the host path; on CUDA it would try the
    DIA loop, then the packed loop, from 16384 rows, as the reference on
    an accelerator.  ``plan_dia`` decides as the reference's."""
    assert tpi._device_route("auto", "cpu", 100_000) == (False, False)
    assert tpi._device_route("auto", "cuda", 100_000) == (True, True)
    assert tpi._device_route("auto", "cuda", 16383) == (False, False)
    assert tpi._device_route("packed", "cpu", 10) == (False, True)
    assert tpi._device_route("general", "cuda", 10 ** 6) == (False, False)

    def boom(*a, **k):
        raise AssertionError("auto took a device path on the CPU")

    monkeypatch.setattr(pk, "generate_packed", boom)
    monkeypatch.setattr(tdia, "generate_dia", boom)
    d = build_matrix_data({"fem": 1024, "offscale": 1.2})
    A, Aj = _both(d)
    _assert_same_factors(ParIlut(iterations=2).generate(A),
                         jpi.ParIlut(iterations=2).generate(Aj))
    for data in (stencil_3d(10, points=27), d,
                 _banded_random(300, 40, 4, seed=2)):
        dc = data.canonical()
        for ours, theirs in ((tdia.plan_dia, jdia.plan_dia),
                             (tdia.plan_dia_ict, jdia.plan_dia_ict)):
            p, q = ours(dc), theirs(_jdata(dc))
            assert (p is None) == (q is None)
            if p is not None:
                for k in p:
                    np.testing.assert_array_equal(p[k], q[k])
    assert tdia.plan_dia(d.canonical()) is None


def test_dia_loop_raises_where_its_plan_accepts():
    """The device DIA loop is still to be ported: where ``plan_dia``
    accepts, ``generate_dia`` raises naming the ROADMAP item (so ``auto``
    on a CUDA stencil raises); where it declines it returns None."""
    s = stencil_3d(8, points=27).canonical()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdia.generate_dia(s, 2, 2.0, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdia.generate_dia_ict(s, 2, 2.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ParIlut(iterations=2, algorithm="dia").generate(
            gtt.Csr.from_data(s, device="cpu"))
    fem = build_matrix_data({"fem": 1024, "offscale": 1.2}).canonical()
    assert tdia.generate_dia(fem, 2, 2.0, 1) is None
    assert tdia.generate_dia_ict(fem, 2, 2.0) is None


@pytest.mark.parametrize("P", [ParIlut, ParIct], ids=["ilut", "ict"])
def test_route_is_recorded(P, monkeypatch):
    """The factorization names the path that made it; where the packed plan
    declines on the CPU, ``packed`` goes on to the host path, as the
    reference does."""
    d = _symmetric(_banded_random(300, 8, 4, seed=3))
    A = gtt.Csr.from_data(d, device="cpu")
    assert P(iterations=2, algorithm="packed").generate(A).route == "packed"
    assert P(iterations=2, algorithm="general").generate(A).route == "general"
    assert P(iterations=2).generate(A).route == "general"
    for name in ("generate_packed", "generate_packed_ict"):
        monkeypatch.setattr(pk, name, lambda *a, **k: None)
    assert P(iterations=2, algorithm="packed").generate(A).route == "general"


@pytest.mark.parametrize("path", ["packed", "dia"])
def test_declined_device_path_raises_on_cuda_when_named(path):
    """On a CUDA device a caller who named a device path gets an error when
    its plan declines; ``auto`` and the CPU go on to the host path."""
    from ginkgo_tpu_torch.base.exceptions import NotSupportedError
    with pytest.raises(NotSupportedError, match=f"algorithm='{path}'"):
        tpi._declined("ParIlut", path, "cuda", path)
    with pytest.raises(ValueError, match="host path"):
        tpi._declined("ParIct", path, torch.device("cuda", 0), path)
    tpi._declined("ParIlut", "auto", "cuda", path)
    tpi._declined("ParIlut", path, "cpu", path)
    other = "dia" if path == "packed" else "packed"
    tpi._declined("ParIlut", other, "cuda", path)


def test_packed_ilu_bicgstab_matches_jax():
    d = _banded_random(800, 10, 5, seed=5)
    A, Aj = _both(d)
    b = np.stack([np.ones(800),
                  np.random.default_rng(0).standard_normal(800)], axis=1)
    Mj = JIlu(factorization=jpi.ParIlut(iterations=3,
                                        algorithm="packed")).generate(Aj)
    rj = JBicgstab.solve(Aj, jnp.asarray(b),
                         criteria=JIteration(500) | JResidualNorm(1e-10),
                         preconditioner=Mj)
    M = Ilu(factorization=ParIlut(iterations=3,
                                  algorithm="packed")).generate(A)
    assert (M.l_solver.algorithm, M.u_solver.algorithm) == (
        Mj.l_solver.algorithm, Mj.u_solver.algorithm)
    rt = Bicgstab.solve(A, torch.from_numpy(b),
                        criteria=Iteration(500) | ResidualNorm(1e-10),
                        preconditioner=M)
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    assert bool(rt.converged.all())
    plain = Bicgstab.solve(A, torch.from_numpy(b),
                           criteria=Iteration(500) | ResidualNorm(1e-10))
    assert int(rt.iterations.max()) < int(plain.iterations.max())
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8,
                               atol=1e-8 * float(np.abs(rj.x).max()))


def test_plan_cache_is_tier_keyed():
    """The cached plan's CONTENT is tier-dependent (kernel streams on the
    cuda tier, raw pair triples on the reference tier) — a plan cached
    under one tier is never served to a generate under the other."""
    pk._PLAN_CACHE.clear()
    d = _banded_random(500, 9, 5, seed=13)
    with use_tier("reference"):
        p_ref = pk._cached_plan(d, "ilut", 2, 2.0, pk.plan_packed_ilut)
    with use_tier("cuda"):
        p_cuda = pk._cached_plan(d, "ilut", 2, 2.0, pk.plan_packed_ilut)
    assert p_ref is not p_cuda
    assert p_ref["prod"]["kernel"] is None
    assert p_cuda["prod"]["kernel"] is not None
    with use_tier("reference"):
        assert pk._cached_plan(d, "ilut", 2, 2.0,
                               pk.plan_packed_ilut) is p_ref
    # the plain device default is the reference tier on the CPU
    assert pk._cached_plan(d, "ilut", 2, 2.0, pk.plan_packed_ilut,
                           device="cpu") is p_ref


def test_kernel_plans_on_cpu_count_and_track_reference(monkeypatch):
    """The cuda tier's path on CPU tensors (kernel plans contracted by the
    plain version of kernel D): one generate with iterations=5 and two
    sweeps calls the contraction 42 times, 23 on the product plan and 19
    on the denominator plan, and gives the reference tier's factors to
    summation order."""
    d = _banded_random(800, 10, 5, seed=5)
    calls = []
    real = pc.pair_contract_cumsum_cuda

    def counting(a, b, arrs, meta_items):
        calls.append(dict(meta_items)["n_out"])
        return real(a, b, arrs, meta_items)

    monkeypatch.setattr(pc, "pair_contract_cumsum_cuda", counting)
    pk._PLAN_CACHE.clear()
    with use_tier("cuda"):
        out = pk.generate_packed(d, 5, 2.0, 2)
    plan = pk._PLAN_CACHE.get(("ilut", True), next(iter(
        pk._PLAN_CACHE._slots.values()))[0])
    nl, nu = plan["nl"], plan["nu"]
    assert len(calls) == 42
    assert calls.count(nl + nu) == 23 and calls.count(nl) == 19
    ref = pk.generate_packed(d, 5, 2.0, 2)
    for a, b in zip(out, ref):
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-10,
                                       atol=1e-10 * np.abs(b).max())
        else:
            np.testing.assert_array_equal(a, b)


def test_plan_reuse_and_purity(monkeypatch):
    """A second generate on a same-pattern matrix skips the planning and
    ships no new plan; new values give new factors; the input is left as
    it was."""
    pk._PLAN_CACHE.clear()
    calls = []
    real = pk.plan_packed_ilut
    monkeypatch.setattr(pk, "plan_packed_ilut",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    d = _banded_random(500, 9, 5, seed=13)
    vals0, row0 = d.values.copy(), d.row_idx.copy()
    out1 = pk.generate_packed(d, iterations=2, fill_in_limit=2.0, sweeps=2)
    np.testing.assert_array_equal(d.values, vals0)
    np.testing.assert_array_equal(d.row_idx, row0)
    d2 = MatrixData(d.shape, d.row_idx, d.col_idx, d.values * 2.0)
    out2 = pk.generate_packed(d2, iterations=2, fill_in_limit=2.0, sweeps=2)
    assert len(calls) == 1
    np.testing.assert_array_equal(out1[0], out2[0])
    np.testing.assert_allclose(out2[2], out1[2], rtol=1e-6)
    np.testing.assert_allclose(out2[5], 2.0 * out1[5], rtol=1e-6)


def test_stagetimer_splits_the_generate():
    d = _banded_random(500, 9, 5, seed=13)
    assert not stagetimer.active()
    x = torch.ones(3)
    assert stagetimer.sync(x) is x
    with stagetimer.collect() as st:
        assert stagetimer.active()
        pk.generate_packed(d, iterations=2, fill_in_limit=2.0, sweeps=2)
    assert set(st.stages) == {"transfer", "device"}
    assert all(v >= 0 for v in st.stages.values())
    assert not stagetimer.active()
