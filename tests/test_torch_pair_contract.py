"""The pair contraction (``ops/pair_contract.py``) and the threshold select
and compaction of ``factorization/par_ilut_dia.py``: the port against
ginkgo_tpu on the same numpy inputs, on the CPU.

Plans from the port's native and numpy planners must equal the JAX
package's array for array.  The plain version of kernels D and E
(``pair_contract_planned_reference`` on a kernel plan) must agree with the
JAX package's Pallas kernels in interpret mode under the same
``_DOT_MODE`` within 1e-5 of max|y| (f32 sums in another order, and the
cumsum-difference loses digits to cancellation on both sides).
``_topk_mask`` and ``_compact_device`` must keep exactly the reference's
slots."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginkgo_tpu import native as jnative
from ginkgo_tpu.factorization import par_ilut_dia as jdia
from ginkgo_tpu.ops import pair_contract as jpc
from ginkgo_tpu_torch import native
from ginkgo_tpu_torch.factorization import par_ilut_dia as tdia
from ginkgo_tpu_torch.ops import pair_contract as pc
from ginkgo_tpu_torch.ops import registry

STREAMS = ("pls", "pus", "pos", "pes", "pesp", "lq", "uq", "nv", "lbase",
           "ubase")


# the synthetic pair lists of the JAX package's tests/test_parilut_packed.py
def _banded_list():
    """Seed 0: a banded list whose block windows never spill."""
    rng = np.random.default_rng(0)
    n_out, n_a, n_b = 5000, 3000, 3500
    po = np.repeat(np.arange(n_out), rng.poisson(2.5, n_out))
    m = len(po)
    pl = np.clip((po * n_a) // n_out + rng.integers(-300, 300, m),
                 0, n_a - 1)
    pu = np.clip((po * n_b) // n_out + rng.integers(-2000, 2000, m),
                 0, n_b - 1)
    return (pl, pu, po, n_out, n_a, n_b), {}, rng


def _spill_list():
    """Seed 1: pairs beyond the per-tile vreg budget (nv_cap=4) spill to
    the COO tail."""
    rng = np.random.default_rng(1)
    n_out = 1024
    po = np.sort(rng.integers(0, n_out, 40000))
    pl = rng.integers(0, 2048, len(po))
    pu = rng.integers(0, 2048, len(po))
    return (pl, pu, po, n_out, 2048, 2048), dict(nv_cap=4,
                                                 max_tail=1.0), rng


def _outlier_list():
    """Seed 7: far window outliers leave the median-anchored window."""
    rng = np.random.default_rng(7)
    n_out = n_a = n_b = 600_000
    m = 60_000
    po = np.sort(rng.integers(0, n_out, m).astype(np.int32))
    pl = np.clip(po.astype(np.int64) + rng.integers(-400, 400, m),
                 0, n_a - 1).astype(np.int32)
    pu = np.clip(po.astype(np.int64) + rng.integers(-400, 400, m),
                 0, n_b - 1).astype(np.int32)
    out = rng.integers(0, m, 500)
    pl[out] = rng.integers(0, n_a, 500)
    return (pl, pu, po, n_out, n_a, n_b), {}, rng


def _wide_list():
    """Seed 3: the wide-spread class that plans only at coarse windows
    (shifts > 0)."""
    rng = np.random.default_rng(3)
    n_out, n_a, n_b = 50000, 30000, 35000
    po = np.repeat(np.arange(n_out), rng.poisson(4.0, n_out))
    m = len(po)
    pl = np.clip((po * n_a) // n_out + rng.integers(-3000, 3000, m),
                 0, n_a - 1)
    pu = np.clip((po * n_b) // n_out + rng.integers(-20000, 20000, m),
                 0, n_b - 1)
    shifts = jpc._select_shifts(pl, pu, po, n_out, jpc._NV_CAP)
    return (pl, pu, po, n_out, n_a, n_b), dict(shifts=shifts), rng


def _modes_list():
    """Seed 11: the list of the JAX package's scatter-modes test."""
    rng = np.random.default_rng(11)
    n_out = n_a = n_b = 30000
    m = 150000
    po = np.sort(rng.integers(0, n_out, m).astype(np.int32))
    pl = np.clip(po + rng.integers(-250, 250, m), 0, n_a - 1).astype(
        np.int32)
    pu = np.clip(po + rng.integers(-250, 250, m), 0, n_b - 1).astype(
        np.int32)
    return (pl, pu, po, n_out, n_a, n_b), {}, rng


LISTS = {"banded": _banded_list, "spill": _spill_list,
         "outliers": _outlier_list, "wide": _wide_list,
         "modes": _modes_list}


def _assert_plans_equal(p, q):
    assert (p is None) == (q is None)
    if p is None:
        return
    assert p["meta"] == q["meta"]
    assert p["fill"] == q["fill"]
    for k in STREAMS:
        assert p[k].dtype == q[k].dtype, k
        np.testing.assert_array_equal(p[k], q[k], err_msg=k)
    for a, b in zip(p["tail"], q["tail"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(LISTS))
def test_plans_equal_jax(name):
    """Native and numpy planners of the port against the JAX package's,
    array for array: streams, windows, vreg counts, tail, meta, fill."""
    args, kw, _ = LISTS[name]()
    p = pc.plan_pair_contract(*args, **kw)
    q = jpc.plan_pair_contract(*args, **kw)
    assert p is not None
    _assert_plans_equal(p, q)
    sl, su = kw.get("shifts", (0, 0))
    nkw = {k: v for k, v in kw.items() if k != "shifts"}
    pn = pc._plan_pair_contract_numpy(*args, sl=sl, su=su, **nkw)
    _assert_plans_equal(pn, jpc._plan_pair_contract_numpy(*args, sl=sl,
                                                          su=su, **nkw))
    # the native tier and the numpy oracle agree on everything but the
    # order of the tail
    assert pn["meta"] == p["meta"]
    for k in ("nv", "lbase", "ubase", "lq", "uq", "pes", "pesp"):
        np.testing.assert_array_equal(pn[k], p[k])
    assert len(pn["tail"][0]) == len(p["tail"][0])
    if name == "spill":
        assert len(p["tail"][0]) > 0
    if name == "outliers":
        assert len(p["tail"][0]) > 0
    if name == "wide":
        assert (sl, su) != (0, 0)
        meta = dict(p["meta"])
        assert meta["GWL"] == 8 << sl and meta["GWU"] == 8 << su
        assert pc._select_shifts(args[0], args[1], args[2], args[3],
                                 pc._NV_CAP) == (sl, su)
        assert pc.plan_pair_contract(*args, shifts=(0, 0)) is None


def test_unsorted_po_and_native_absent_plan_like_jax(monkeypatch):
    """An unsorted list is po-sorted first; without the native library the
    numpy planner serves, with the same plan."""
    args, kw, rng = _banded_list()
    pl, pu, po = args[:3]
    perm = rng.permutation(len(po))
    p3 = pc.plan_pair_contract(pl[perm], pu[perm], po[perm], *args[3:])
    q3 = jpc.plan_pair_contract(pl[perm], pu[perm], po[perm], *args[3:])
    _assert_plans_equal(p3, q3)
    monkeypatch.setattr(native, "lib", lambda: None)
    assert native.pair_plan_native(pl, pu, po, args[3], 4, 2048, 1.0) is None
    _assert_plans_equal(pc.plan_pair_contract(*args),
                        jpc._plan_pair_contract_numpy(*args))


def _torch_arrs(plan):
    arrs = {k: torch.from_numpy(plan[k]) for k in STREAMS}
    arrs["tail"] = tuple(torch.from_numpy(t).long() for t in plan["tail"])
    return arrs


def _jax_arrs(plan):
    arrs = {k: jnp.asarray(plan[k]) for k in STREAMS}
    arrs["tail"] = tuple(jnp.asarray(t) for t in plan["tail"])
    return arrs


@pytest.fixture
def dot_mode():
    """Sets ``_DOT_MODE`` in both packages; restores both after."""
    prev, jprev = pc._DOT_MODE, jpc._DOT_MODE

    def set_mode(mode):
        pc._DOT_MODE = jpc._DOT_MODE = mode

    try:
        yield set_mode
    finally:
        pc._DOT_MODE, jpc._DOT_MODE = prev, jprev


@pytest.mark.parametrize("mode", ["cumsum_batched", "onehot"])
@pytest.mark.parametrize("name", ["banded", "spill", "wide", "modes"])
def test_planned_plain_matches_jax_interpret(name, mode, dot_mode):
    """The plain version of kernels D and E against the JAX package's
    Pallas kernels in interpret mode, same plan, same mode."""
    args, kw, rng = LISTS[name]()
    plan = pc.plan_pair_contract(*args, **kw)
    n_a, n_b = args[4], args[5]
    a = rng.standard_normal(n_a).astype(np.float32)
    b = rng.standard_normal(n_b).astype(np.float32)
    dot_mode(mode)
    want = np.asarray(jpc.pair_contract_pallas(
        jnp.asarray(a), jnp.asarray(b), _jax_arrs(plan), plan["meta"],
        interpret=True))
    got = pc.pair_contract_planned_reference(
        torch.from_numpy(a), torch.from_numpy(b), _torch_arrs(plan),
        plan["meta"])
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() / scale < 1e-5
    # and against the exact oracle, as the JAX package's tests hold it
    oracle = np.zeros(args[3], np.float64)
    np.add.at(oracle, args[2], a[args[0]].astype(np.float64) * b[args[1]])
    assert np.abs(got.numpy() - oracle).max() / np.abs(oracle).max() < 1e-5


def test_planned_plain_f64_and_tiers(dot_mode):
    """In f64 the plain version accumulates in f64 (the kernels' f64
    instantiation does too); the cuda wrapper takes it on CPU tensors
    without counting a launch; a raw plan goes through the oracle."""
    args, kw, rng = _spill_list()
    plan = pc.plan_pair_contract(*args, **kw)
    a = torch.from_numpy(rng.standard_normal(args[4]))
    b = torch.from_numpy(rng.standard_normal(args[5]))
    pl, pu, po = (torch.from_numpy(np.asarray(x)) for x in args[:3])
    oracle = pc.pair_contract_reference(a, b, pl, pu, po, args[3])
    arrs = _torch_arrs(plan)
    for mode in ("cumsum_batched", "onehot"):
        dot_mode(mode)
        before = (pc.pair_contract_cumsum_cuda.launches,
                  pc.pair_contract_onehot_cuda.launches)
        for fn in (pc.pair_contract_planned_reference,
                   pc.pair_contract_planned_cuda,
                   registry.lookup("pair_contract_planned", "cpu")):
            y = fn(a, b, arrs, plan["meta"])
            assert y.dtype == torch.float64
            torch.testing.assert_close(y, oracle, rtol=1e-12, atol=1e-12)
        assert (pc.pair_contract_cumsum_cuda.launches,
                pc.pair_contract_onehot_cuda.launches) == before
    raw = {"raw": (pl, pu, po)}
    torch.testing.assert_close(
        pc.pair_contract_planned_reference(a, b, raw, plan["meta"]), oracle)
    with pytest.raises(ValueError, match="raw-triple"):
        pc.pair_contract_planned_cuda(a, b, raw, plan["meta"])
    with registry.use_tier("cuda"):
        assert registry.lookup("pair_contract_planned", "cpu") is \
            pc.pair_contract_planned_cuda
        assert registry.lookup("pair_contract", "cpu") is \
            pc.pair_contract_reference


def test_empty_tile_contributes_zeros():
    """Outputs of a tile with no pairs (nv[t] == 0) are zero."""
    rng = np.random.default_rng(4)
    po = np.sort(np.concatenate([rng.integers(0, 1024, 3000),
                                 rng.integers(2048, 3000, 3000)]))
    pl = np.clip(po + rng.integers(-100, 100, po.size), 0, 2999)
    pu = np.clip(po + rng.integers(-100, 100, po.size), 0, 2999)
    plan = pc.plan_pair_contract(pl, pu, po, 3000, 3000, 3000)
    assert plan["nv"][1] == 0 and (plan["nv"][[0, 2]] > 0).all()
    a = torch.from_numpy(rng.standard_normal(3000))
    b = torch.from_numpy(rng.standard_normal(3000))
    y = pc.pair_contract_planned_reference(a, b, _torch_arrs(plan),
                                           plan["meta"])
    assert bool((y[1024:2048] == 0).all())
    want = pc.pair_contract_reference(a, b, torch.from_numpy(pl),
                                      torch.from_numpy(pu),
                                      torch.from_numpy(po), 3000)
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
def test_raw_reference_matches_jax(dtype):
    args, _, rng = _outlier_list()
    pl, pu, po, n_out, n_a, n_b = args
    a = rng.standard_normal(n_a).astype(dtype)
    b = rng.standard_normal(n_b).astype(dtype)
    want = np.asarray(jpc.pair_contract_reference(
        jnp.asarray(a), jnp.asarray(b), pl, pu, po, n_out))
    got = pc.pair_contract_reference(torch.from_numpy(a),
                                     torch.from_numpy(b), pl, pu, po, n_out)
    assert got.numpy().dtype == want.dtype
    tol = 1e-6 if dtype == np.float32 else 1e-14
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _topk_inputs(dtype):
    rng = np.random.default_rng(5)
    n = 5000
    mag = np.abs(rng.standard_normal(n)).astype(dtype)
    mag[::7] = mag[3]                      # a block of exact ties
    mag[10:400] = 0.0                      # zero-magnitude ties
    mag[500] = np.inf                      # a pinned diagonal
    mag[501] = 1e-30
    active = (rng.random(n) < 0.8).astype(np.uint8)
    return mag, active


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
@pytest.mark.parametrize("k", [0, 1, 37, 714, 2500, 3999, 5000, 7000])
def test_topk_mask_matches_jax(dtype, k):
    mag, active = _topk_inputs(dtype)
    want = np.asarray(jdia._topk_mask(jnp.asarray(mag), jnp.asarray(active),
                                      k))
    got = tdia._topk_mask(torch.from_numpy(mag), torch.from_numpy(active), k)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) <= max(k, 0) or k >= mag.size


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=str)
@pytest.mark.parametrize("kmax", [0, 100, 4000, 6000])
def test_compact_device_matches_jax(dtype, kmax):
    mag, active = _topk_inputs(dtype)
    vals = mag * np.where(np.arange(mag.size) % 2, -1, 1).astype(dtype)
    want = jdia._compact_device(jnp.asarray(vals), jnp.asarray(active), kmax)
    got = tdia._compact_device(torch.from_numpy(vals),
                               torch.from_numpy(active), kmax)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32


def test_native_bindings_match_jax_loader():
    """The port's bindings of the ParILUT/ParICT entry points give the JAX
    loader's results on the same inputs."""
    rng = np.random.default_rng(6)
    n = 300
    rows = np.repeat(np.arange(n), 6)
    cols = np.clip(rows + rng.integers(-12, 13, rows.size), 0, n - 1)
    key = np.unique(np.concatenate([rows * n + cols,
                                    np.arange(n) * (n + 1)]))
    r, c = key // n, key % n
    low = r > c
    for fn in ("ilut_pairs_rowmajor_native",):
        got = getattr(native, fn)(n, r[low], c[low], r[~low], c[~low],
                                  cap=1 << 30)
        want = getattr(jnative, fn)(n, r[low], c[low], r[~low], c[~low],
                                    cap=1 << 30)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    lw = r >= c
    got = native.ict_pairs_rowmajor_native(n, r[lw], c[lw], cap=1 << 30)
    want = jnative.ict_pairs_rowmajor_native(n, r[lw], c[lw], cap=1 << 30)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert native.ict_pairs_rowmajor_native(n, r[lw], c[lw], cap=10) is None
