"""The pad-free pair stream of kernels D and E (``ops/pair_contract.py::
pair_stream``) and the kernels' walk over it, emulated on the CPU
(``tests/pair_walk.py``).

The stream must hold exactly the planned (non-tail) pairs, each once, in
slot order within each live vreg (po-ascending), each vreg's range padded
to a multiple of 8 with pairs of slot 1024 only, and the COO tail sorted
by po in one segment an output slot.  The emulated walk of kernel D
(lane-local runs, the segmented shuffle scan across lanes, the carry
between groups) and of kernel E (the slot scatter), COO tail included, is
held against the JAX
package's Pallas kernels in interpret mode under the same ``_DOT_MODE`` and
against the f64 oracle of the raw triples, within 1e-5 of max|y| in f32
(the JAX kernels sum in f32 in another order) and 1e-12 in f64; on plans
with empty tiles, a COO tail and runs that cross lanes and groups."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pair_walk
from ginkgo_tpu.ops import pair_contract as jpc
from ginkgo_tpu_torch.ops import pair_contract as pc
from test_torch_pair_contract import LISTS, STREAMS

SLABS = ("pls", "pus", "pos", "lq", "uq", "nv", "lbase", "ubase")


def _runs_list():
    """Seed 12: few outputs with about 90 pairs each, so kernel D's runs
    cross many 32-pair steps and carry."""
    rng = np.random.default_rng(12)
    n_out = n_a = n_b = 3000
    po = np.repeat(np.arange(0, n_out, 7), rng.poisson(90, -(-n_out // 7)))
    pl = np.clip(po + rng.integers(-300, 300, po.size), 0, n_a - 1)
    pu = np.clip(po + rng.integers(-300, 300, po.size), 0, n_b - 1)
    return (pl, pu, po, n_out, n_a, n_b), {}, rng


def _empty_tile_list():
    """Seed 4: tile 1 holds no pair (nv[1] == 0)."""
    rng = np.random.default_rng(4)
    po = np.sort(np.concatenate([rng.integers(0, 1024, 3000),
                                 rng.integers(2048, 3000, 3000)]))
    pl = np.clip(po + rng.integers(-100, 100, po.size), 0, 2999)
    pu = np.clip(po + rng.integers(-100, 100, po.size), 0, 2999)
    return (pl, pu, po, 3000, 3000, 3000), {}, rng


ALL = {**LISTS, "runs": _runs_list, "empty_tile": _empty_tile_list}


@functools.lru_cache(maxsize=None)
def _case(name):
    """The list, its plan, its stream and f32 operands."""
    args, kw, rng = ALL[name]()
    plan = pc.plan_pair_contract(*args, **kw)
    slabs = {k: torch.from_numpy(plan[k]) for k in SLABS}
    slabs["tail"] = tuple(torch.from_numpy(t) for t in plan["tail"])
    st = pc.pair_stream(slabs, plan["meta"])
    a = rng.standard_normal(args[4]).astype(np.float32)
    b = rng.standard_normal(args[5]).astype(np.float32)
    return args, plan, st, a, b


@functools.lru_cache(maxsize=None)
def _jax_y(name, mode):
    """The JAX package's Pallas kernel of ``mode`` in interpret mode."""
    _, plan, _, a, b = _case(name)
    prev = jpc._DOT_MODE
    jpc._DOT_MODE = mode
    try:
        arrs = {k: jnp.asarray(plan[k]) for k in STREAMS}
        arrs["tail"] = tuple(jnp.asarray(t) for t in plan["tail"])
        return np.asarray(jpc.pair_contract_pallas(
            jnp.asarray(a), jnp.asarray(b), arrs, plan["meta"],
            interpret=True))
    finally:
        jpc._DOT_MODE = prev


def _oracle(args, a, b):
    y = np.zeros(args[3], np.float64)
    np.add.at(y, args[2], a[args[0]].astype(np.float64) * b[args[1]])
    return y


def _contract(name, mode, dtype):
    """The emulated kernel, COO tail included."""
    args, plan, st, a, b = _case(name)
    at = torch.from_numpy(a).to(dtype)
    bt = torch.from_numpy(b).to(dtype)
    y = pair_walk.walk(at, bt, st, plan["meta"], mode)
    return pair_walk.tail(at, bt, st, y).numpy()


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", list(ALL))
def test_stream_holds_the_planned_pairs_once(name):
    args, plan, st, _, _ = _case(name)
    meta = dict(plan["meta"])
    T = meta["T"]
    tail = len(plan["tail"][0])
    nvr = int(plan["nv"].sum())
    assert st["vstart"].shape == (nvr + 1,) and st["va"].shape == (nvr,)
    assert all(st[k].dtype == torch.int16 for k in ("cl", "cu", "co"))
    np.testing.assert_array_equal(
        st["tstart"].numpy(), np.concatenate([[0], np.cumsum(plan["nv"])]))
    vstart = st["vstart"].numpy()
    co = st["co"].numpy()
    real = co < 1024
    assert int(vstart[-1]) == co.size and (vstart % 8 == 0).all()
    assert int(real.sum()) == len(args[2]) - tail
    # padding: fewer than 8 pairs a vreg, after its real pairs, slot
    # 1024 and indices 0
    vreg = np.repeat(np.arange(nvr), np.diff(vstart))
    npad = np.bincount(vreg[~real], minlength=nvr)
    assert (npad < 8).all()
    nreal = np.bincount(vreg[real], minlength=nvr)
    assert (nreal > 0).all()
    assert (np.arange(co.size) - vstart[vreg] < nreal[vreg])[real].all()
    assert not st["cl"].numpy()[~real].any()
    assert not st["cu"].numpy()[~real].any()
    tile = np.repeat(np.arange(T), plan["nv"])[vreg]
    pl = (st["va"].numpy()[vreg].astype(np.int64) * 128
          + st["cl"].numpy())[real]
    pu = (st["vb"].numpy()[vreg].astype(np.int64) * 128
          + st["cu"].numpy())[real]
    po = (tile.astype(np.int64) * 1024 + co)[real]
    # the stream and the tail together are the list, each pair once
    got = np.sort(np.concatenate([(po << 42) | (pl << 21) | pu,
                                  (plan["tail"][2].astype(np.int64) << 42)
                                  | (plan["tail"][0].astype(np.int64)
                                     << 21) | plan["tail"][1]]))
    want = np.sort((np.asarray(args[2], np.int64) << 42)
                   | (np.asarray(args[0], np.int64) << 21)
                   | np.asarray(args[1], np.int64))
    np.testing.assert_array_equal(got, want)
    # within a vreg: slot order (po-ascending)
    key = co[real]
    vr = vreg[real]
    same = vr[1:] == vr[:-1]
    assert bool((key[1:][same] >= key[:-1][same]).all())
    # the tail, po-sorted (stable), one segment an output slot
    tpo, tseg = st["tpo"].numpy(), st["tseg"].numpy()
    assert all(st[k].dtype == torch.int32 for k in ("tl", "tu", "tseg",
                                                    "tpo"))
    assert tseg[0] == 0 and tseg[-1] == tail and (np.diff(tseg) > 0).all()
    assert (np.diff(tpo) > 0).all()
    order = np.argsort(plan["tail"][2], kind="stable")
    np.testing.assert_array_equal(st["tl"].numpy(), plan["tail"][0][order])
    np.testing.assert_array_equal(st["tu"].numpy(), plan["tail"][1][order])
    np.testing.assert_array_equal(np.repeat(tpo, np.diff(tseg)),
                                  plan["tail"][2][order])
    if name == "empty_tile":
        assert plan["nv"][1] == 0
    if name in ("spill", "outliers"):
        assert tail > 0


@pytest.mark.parametrize("mode", ["cumsum_batched", "onehot"])
@pytest.mark.parametrize("name", ["banded", "spill", "wide", "modes"])
def test_walk_matches_jax_interpret_and_oracle(name, mode):
    """Both value types against the JAX kernel (f32) and the oracle."""
    args, _, _, a, b = _case(name)
    want = _jax_y(name, mode)
    oracle = _oracle(args, a, b)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        got = _contract(name, mode, dtype)
        assert got.dtype == (np.float32 if dtype == torch.float32
                             else np.float64)
        assert _rel(got, want) < 1e-5
        assert _rel(got, oracle) < tol


@pytest.mark.parametrize("name", ["runs", "empty_tile", "outliers"])
def test_walk_on_runs_empty_tiles_and_outliers(name):
    """D and E on long runs, an empty tile (zeros there) and window
    outliers in the tail, against the oracle."""
    args, _, _, a, b = _case(name)
    oracle = _oracle(args, a, b)
    for mode in ("cumsum_batched", "onehot"):
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            got = _contract(name, mode, dtype)
            assert _rel(got, oracle) < tol
            if name == "empty_tile":
                assert (got[1024:2048] == 0).all()


def test_walk_d_is_the_segmented_sum_of_each_vreg():
    """In f64 on integer-valued operands every order of sums is exact, so
    the emulated kernel D equals the oracle bit for bit; the runs cross
    lanes and groups of 256 pairs (the carry), and a slot takes pairs from
    several vregs."""
    args, plan, st, _, _ = _case("runs")
    vstart = st["vstart"].numpy()
    co = st["co"].numpy()
    assert (np.diff(vstart) > 256).any()
    assert max(np.bincount(co[s:e][co[s:e] < 1024]).max()
               for s, e in zip(vstart[:-1], vstart[1:])) > 8
    vreg = np.repeat(np.arange(len(vstart) - 1), np.diff(vstart))
    tile = np.repeat(np.arange(dict(plan["meta"])["T"]), plan["nv"])[vreg]
    slots = (tile * 1024 + co)[co < 1024]
    assert len(np.unique(slots)) < len(np.unique(np.stack(
        [vreg[co < 1024], slots]), axis=1)[0])      # slots in two vregs
    g = np.random.default_rng(13)
    a = g.integers(-8, 9, args[4]).astype(np.float64)
    b = g.integers(-8, 9, args[5]).astype(np.float64)
    y = pair_walk.walk(torch.from_numpy(a), torch.from_numpy(b), st,
                       plan["meta"], "cumsum_batched")
    y = pair_walk.tail(torch.from_numpy(a), torch.from_numpy(b), st, y)
    np.testing.assert_array_equal(y.numpy(), _oracle(args, a, b))


def test_cuda_wrappers_need_the_stream_on_the_card():
    """Without a card the wrappers take the plain version on the slabs;
    the launch path refuses slab-only plans (no repack hidden in a
    call)."""
    _, plan, st, a, b = _case("spill")
    arrs = {k: torch.from_numpy(plan[k]) for k in STREAMS}
    arrs["tail"] = tuple(torch.from_numpy(t).long() for t in plan["tail"])
    with pytest.raises(ValueError, match="pair stream"):
        pc._launch(pc.pair_contract_cumsum_cuda, 0, torch.from_numpy(a),
                   torch.from_numpy(b), arrs, plan["meta"])
    bad = dict(arrs, stream=dict(st, vstart=st["vstart"].int()))
    with pytest.raises(ValueError, match="do not fit"):
        pc._launch(pc.pair_contract_onehot_cuda, 1, torch.from_numpy(a),
                   torch.from_numpy(b), bad, plan["meta"])
    with pytest.raises(NotImplementedError, match="queue 3"):
        pc._launch(pc.pair_contract_onehot_cuda, 1,
                   torch.from_numpy(a).to(torch.complex64),
                   torch.from_numpy(b).to(torch.complex64), arrs,
                   plan["meta"])


def test_shipped_plan_is_memoized_per_mode_on_the_cpu():
    """On the CPU the plain version reads the slabs of the active mode, so
    the shipped plan is kept per mode; the same mode ships once."""
    from ginkgo_tpu_torch.factorization import par_ilut_packed as pk
    _, plan, _, _, _ = _case("spill")
    cplan = {"kernel": plan}
    prev = pc._DOT_MODE
    try:
        pc._DOT_MODE = "cumsum_batched"
        d = pk._ship_contract(cplan, "cpu")
        assert pk._ship_contract(cplan, "cpu") is d
        assert {"pes", "pesp"} <= set(d[0]) and "pos" not in d[0]
        pc._DOT_MODE = "onehot"
        e = pk._ship_contract(cplan, "cpu")
        assert e is not d and "pos" in e[0] and "pes" not in e[0]
    finally:
        pc._DOT_MODE = prev
