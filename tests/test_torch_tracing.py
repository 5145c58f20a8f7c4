"""The tracer (``log/profiler_hook.py``) inside the solver loops, on the CPU:
what the spans and the host-read counter record, that they cost no clock
or profiler call while nothing records, and that recording changes no
result."""

import collections
import json
import time

import numpy as np
import pytest
import torch

from ginkgo_tpu_torch import Csr
from ginkgo_tpu_torch.log import ProfilerHook, capture, record
from ginkgo_tpu_torch.preconditioner.jacobi import Jacobi
from ginkgo_tpu_torch.solver import Cg, Gmres
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import stencil_2d

KRYLOV_DIM = 4


@pytest.fixture(scope="module")
def A():
    return Csr.from_data(stencil_2d(8, points=5), dtype=np.float64,
                         device="cpu")


def _b(A, k=1):
    g = torch.Generator().manual_seed(3)
    return torch.randn((A.shape[0], k), dtype=torch.float64, generator=g)


def _crit():
    return ResidualNorm(reduction_factor=1e-8) | Iteration(max_iters=200)


SOLVES = {
    "cg": lambda A, b, **kw: Cg.solve(A, b, criteria=_crit(),
                                      preconditioner=Jacobi(), **kw),
    "gmres": lambda A, b, **kw: Gmres.solve(A, b, criteria=_crit(),
                                            krylov_dim=KRYLOV_DIM, **kw),
}


def _children(spans, parent):
    return sorted((s for s in spans if s.parent_id == parent.span_id),
                  key=lambda s: s.span_id)


@pytest.mark.parametrize("solver", ["cg", "gmres"])
def test_recording_off_calls_no_clock_and_no_profiler(A, monkeypatch,
                                                      solver):
    def refuse(*a, **kw):
        raise AssertionError("called with recording off")

    b = _b(A)
    with monkeypatch.context() as m:
        for mod, name in ((torch.profiler, "record_function"),
                          (torch.autograd.profiler, "record_function"),
                          (torch.cuda.nvtx, "range_push"),
                          (time, "perf_counter"), (time, "perf_counter_ns")):
            m.setattr(mod, name, refuse)
        res = SOLVES[solver](A, b)
    assert bool(res.converged.all())


def test_cg_iteration_spans(A):
    with record() as rec:
        res = SOLVES["cg"](A, _b(A))
    spans = rec.spans
    iters = [s for s in spans if s.name == "loop.iteration"]
    assert len(iters) == int(res.iterations[0]) > 0
    for it in iters:
        names = collections.Counter(s.name for s in _children(spans, it))
        assert names["loop.host_read"] == 1
        assert names["loop.check"] == 1
    steps = [s for s in spans if s.name in ("step.precond", "step.spmv")]
    by_id = {s.span_id: s for s in spans}
    assert len(steps) == 2 * len(iters)
    assert all(by_id[s.parent_id].name == "loop.iteration" for s in steps)
    assert len([s for s in spans if s.name == "loop.restart"]) >= 1


def test_gmres_iteration_and_restart_spans(A):
    with record() as rec:
        res = SOLVES["gmres"](A, _b(A))
    spans = rec.spans
    solve = next(s for s in spans if s.name == "solver.gmres")
    loop = [s.name for s in _children(spans, solve)
            if s.name in ("loop.iteration", "loop.restart")]
    assert loop.count("loop.iteration") == int(res.iterations[0])
    # cycles: runs of 1..m iterations, each closed by one restart
    cycles = "".join("I" if n == "loop.iteration" else "R"
                     for n in loop).split("R")
    assert cycles[-1] == "" and len(cycles) - 1 >= 3
    assert all(1 <= len(c) <= KRYLOV_DIM for c in cycles[:-1])
    for it in (s for s in spans if s.name == "loop.iteration"):
        names = [s.name for s in _children(spans, it)]
        assert names.count("gmres.project") == 1
        assert names.count("step.spmv") == 1


@pytest.mark.parametrize("solver", ["cg", "gmres"])
def test_spans_share_the_solve_id_and_nest(A, solver):
    with record() as rec:
        SOLVES[solver](A, _b(A))
        SOLVES[solver](A, _b(A))
    by_id = {s.span_id: s for s in rec.spans}
    roots = [s for s in rec.spans if s.parent_id is None]
    assert [s.name for s in roots] == [f"solver.{solver}"] * 2
    assert len({s.solve_id for s in roots}) == 2
    for s in rec.spans:
        root = s
        while root.parent_id is not None:
            parent = by_id[root.parent_id]
            assert parent.t0_ns <= root.t0_ns <= root.t1_ns <= parent.t1_ns
            root = parent
        assert s.solve_id == root.span_id
    reads = sum(s.name == "loop.host_read" for s in rec.spans)
    assert rec.counters["host_reads"] == reads > 0


def test_spans_land_in_the_profiler_trace(A, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            record() as rec:
        SOLVES["gmres"](A, _b(A))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    traced = collections.Counter(
        ev["name"] for ev in events if ev.get("cat") == "user_annotation")
    assert traced == collections.Counter(s.name for s in rec.spans)


def test_profiler_hook_self_time(A):
    with capture(ProfilerHook()) as prof:
        SOLVES["cg"](A, _b(A))
        SOLVES["gmres"](A, _b(A))
    summary = prof.create_summary()
    assert {"solver.cg", "solver.gmres", "loop.iteration",
            "gmres.project"} <= set(summary)
    for _, inclusive, own in summary.values():
        assert 0 <= own <= inclusive
    roots = sum(s.t1_ns - s.t0_ns for s in prof.recording.spans
                if s.parent_id is None) * 1e-9
    assert sum(own for _, _, own in summary.values()) == \
        pytest.approx(roots, rel=1e-9)


@pytest.mark.parametrize("solver,k,trace", [("cg", 1, False),
                                            ("cg", 3, False),
                                            ("cg", 1, True),
                                            ("gmres", 1, False),
                                            ("gmres", 3, False),
                                            ("gmres", 1, True)])
def test_recording_changes_no_result(A, solver, k, trace):
    off = SOLVES[solver](A, _b(A, k), trace=trace)
    with record():
        on = SOLVES[solver](A, _b(A, k), trace=trace)
    assert torch.equal(off.x, on.x)
    assert torch.equal(off.iterations, on.iterations)
    assert torch.equal(off.converged, on.converged)
