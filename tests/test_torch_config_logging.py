"""Config parsing and the logging tier (``config/``, ``log/logger.py``,
``log/profiler_hook.py``): the counterparts of
``tests/test_config_logging.py`` on the port, on the CPU, in f64, with
the type table and the solves held against ginkgo_tpu."""

import io
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
from ginkgo_tpu.config import parse as jparse
from ginkgo_tpu.config.parse import _type_table as jax_type_table
from ginkgo_tpu_torch import Csr
from ginkgo_tpu_torch.base.exceptions import NotSupportedError
from ginkgo_tpu_torch.base.matrix_data import MatrixData
from ginkgo_tpu_torch.config import (parse, parse_json, parse_yaml, pnode,
                                     registry, type_descriptor)
from ginkgo_tpu_torch.config.parse import _type_table
from ginkgo_tpu_torch.log import (Convergence, Logger, PerformanceHint,
                                  ProfilerHook, Record, SolverProgress,
                                  Stream, annotate, capture, trace_to)
from ginkgo_tpu_torch.log import logger as tlog
from ginkgo_tpu_torch.solver import Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm, Time
from ginkgo_tpu_torch.utils.generators import (generate_random_matrix,
                                               make_spd)


def _data(n=30, seed=0):
    return make_spd(generate_random_matrix(
        n, n, nonzeros_per_row=(2, 5), seed=seed), shift=1.0)


def _spd(n=30, seed=0):
    return Csr.from_data(_data(n, seed), device="cpu")


def _ones(n=30):
    return torch.ones(n, dtype=torch.float64)


# -- property tree -------------------------------------------------------------

def test_pnode():
    p = pnode({"a": 1, "b": [1.5, True], "c": "x"})
    assert p.is_map and not p.is_scalar
    assert p.get("a").get_integer() == 1
    assert p.get("b").is_array and p.get("b").at(1).get_boolean()
    assert p.get("c").get_string() == "x"
    assert p.get("missing").is_empty
    assert len(p) == 3 and p.get("b").at(0).get_real() == 1.5
    with pytest.raises(TypeError):
        p.get("a").get_string()
    with pytest.raises(TypeError):
        p.get("b").at(0).get_integer()   # 1.5 is not an integer
    with pytest.raises(TypeError):
        p.get("c").get("x")


# -- the type table --------------------------------------------------------------

def _table_kwargs(name, parse_fn):
    if name == "multigrid::FixedCoarsening":
        return {"coarse_rows": [0, 2]}
    if name == "reorder::ScaledReordered":
        return {"inner_operator": parse_fn({"type": "solver::Cg"})}
    return {}


def test_type_table_builds_the_ports_classes():
    """Every name of the reference's table builds the port's class of the
    reference's class name (the solvers: a factory of that solver)."""
    port, ref = _type_table(), jax_type_table()
    assert set(port) == set(ref)
    for name in sorted(ref):
        if name == "preconditioner::Schwarz":
            continue
        j = ref[name](**_table_kwargs(name, jparse))
        t = port[name](**_table_kwargs(name, parse))
        assert type(t).__module__.startswith("ginkgo_tpu_torch."), name
        assert (type(t).__name__, getattr(t, "name", None)) == (
            type(j).__name__, getattr(j, "name", None)), name


def test_schwarz_raises_until_the_distributed_tier():
    with pytest.raises(NotSupportedError, match="queue 1 item 13"):
        parse({"type": "preconditioner::Schwarz"})


def test_type_descriptor():
    td = type_descriptor()
    assert (td.value_type, td.index_type) == (torch.float64, torch.int32)
    td = type_descriptor("float32", torch.int64)
    assert (td.value_type, td.index_type) == (torch.float32, torch.int64)
    f = parse({"type": "solver::Cg", "criteria": [
        {"type": "stop::Iteration", "max_iters": 5}]}, td=td)
    assert f.name == "Cg"


# -- config parse ----------------------------------------------------------------

def _iterations_match_reference(cfg, seed, apply_rtol):
    """Parse ``cfg`` in both packages, solve A x = 1 on the same matrix:
    the same iterations, and A x = 1 to ``apply_rtol``."""
    A = _spd(seed=seed)
    with capture(Convergence()) as conv:
        x = parse(cfg).generate(A).apply(_ones())
    np.testing.assert_allclose(A.apply(x).numpy(), 1.0, rtol=apply_rtol)
    from ginkgo_tpu.log import Convergence as JConvergence
    from ginkgo_tpu.log import capture as jcapture
    d = _data(seed=seed)
    Aj = gt.Csr.from_data(gt.MatrixData(d.shape, d.row_idx, d.col_idx,
                                        d.values))
    with jcapture(JConvergence()) as jconv:
        jparse(cfg).generate(Aj).apply(jnp.ones(30))
    assert conv.num_iterations == jconv.num_iterations


def test_parse_cg_config():
    _iterations_match_reference({
        "type": "solver::Cg",
        "criteria": [
            {"type": "stop::Iteration", "max_iters": 500},
            {"type": "stop::ResidualNorm", "reduction_factor": 1e-11},
        ],
        "preconditioner": {"type": "preconditioner::Jacobi"},
    }, seed=0, apply_rtol=1e-8)


def test_parse_json_string_and_registry():
    A = _spd(seed=1)
    reg = registry({"my_precond": A.extract_diagonal().inverse()})
    assert "my_precond" in reg and "other" not in reg
    reg.emplace("other", 1)
    assert reg.search_data("other") == 1
    with pytest.raises(KeyError):
        reg.search_data("missing")
    cfg = json.dumps({
        "type": "solver::Bicgstab",
        "criteria": [{"type": "stop::Iteration", "max_iters": 400},
                     {"type": "stop::ResidualNorm",
                      "reduction_factor": 1e-10}],
        "preconditioner": "my_precond",
    })
    solver = parse_json(cfg, reg).generate(A)
    assert solver.preconditioner is reg.search_data("my_precond")
    x = solver.apply(_ones())
    np.testing.assert_allclose(A.apply(x).numpy(), 1.0, rtol=1e-7)


def test_parse_json_file(tmp_path):
    """file-config-solver example analog."""
    path = tmp_path / "solver.json"
    cfg = {"type": "solver::Gmres", "krylov_dim": 20,
           "criteria": [{"type": "stop::Iteration", "max_iters": 300},
                        {"type": "stop::ResidualNorm",
                         "reduction_factor": 1e-10}]}
    path.write_text(json.dumps(cfg))
    A = _spd(seed=2)
    x = parse_json(str(path)).generate(A).apply(_ones())
    np.testing.assert_allclose(A.apply(x).numpy(), 1.0, rtol=1e-7)
    _iterations_match_reference(cfg, seed=2, apply_rtol=1e-7)


def test_parse_nested_ilu_config():
    cfg = {"type": "preconditioner::Ilu",
           "factorization": {"type": "factorization::ParIlu",
                             "iterations": 10}}
    M = parse(cfg).generate(_spd(seed=3))
    assert M.shape == (30, 30)


YAML_ANCHORS = """
type: "solver::Ir"
criteria: &crit
  - {type: "stop::Iteration", max_iters: 40}
  - {type: "stop::ResidualNorm", reduction_factor: 1.0e-10}
solver:
  type: "solver::Cg"
  criteria: *crit
  <<: {preconditioner: {type: "preconditioner::Jacobi"}}
"""


def test_parse_yaml_string_anchor_merge():
    """YAML front end (yaml_config.hpp analog) including the << merge key
    the reference resolves manually (yaml_config.hpp:44-70)."""
    pytest.importorskip("yaml")
    factory = parse_yaml(YAML_ANCHORS)
    inner = dict(factory.params)["solver"]
    assert inner.name == "Cg"
    assert type(dict(inner.params)["preconditioner"]).__name__ == "Jacobi"
    A = _spd(seed=6)
    x = factory.generate(A).apply(_ones())
    np.testing.assert_allclose(A.apply(x).numpy(), 1.0, rtol=1e-7)


def test_parse_yaml_file(tmp_path):
    pytest.importorskip("yaml")
    path = tmp_path / "solver.yaml"
    path.write_text(
        "type: solver::Gmres\n"
        "krylov_dim: 20\n"
        "criteria:\n"
        "  - {type: 'stop::Iteration', max_iters: 300}\n"
        "  - {type: 'stop::ResidualNorm', reduction_factor: 1.0e-10}\n")
    A = _spd(seed=7)
    x = parse_yaml(str(path)).generate(A).apply(_ones())
    np.testing.assert_allclose(A.apply(x).numpy(), 1.0, rtol=1e-7)
    with pytest.raises(ValueError):
        parse_yaml("- 1\n- 2\n")


def test_parse_yaml_without_pyyaml(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="pyyaml"):
        parse_yaml("type: solver::Cg\n")


def test_parse_errors():
    with pytest.raises(ValueError):
        parse({"no_type": 1})
    with pytest.raises(ValueError, match="unknown config type"):
        parse({"type": "solver::DoesNotExist"})
    with pytest.raises(TypeError):
        parse([1, 2, 3])
    assert isinstance(parse(pnode({"type": "stop::Iteration",
                                   "max_iters": 3})), Iteration)


# -- logging ----------------------------------------------------------------------

def test_all_events():
    assert {tlog.SOLVE_STARTED, tlog.IO_READ, tlog.IO_WRITE,
            tlog.BATCH_SOLVE_COMPLETED} <= tlog.ALL_EVENTS
    from ginkgo_tpu.log import logger as jlog
    assert tlog.ALL_EVENTS == jlog.ALL_EVENTS


def test_convergence_logger():
    A = _spd(seed=4)
    with capture(Convergence()) as conv:
        res = Cg.solve(A, _ones(),
                       criteria=Iteration(500) | ResidualNorm(1e-10))
    assert conv.result is res
    assert conv.has_converged()
    assert conv.num_iterations == int(res.iterations.max()) > 0
    assert isinstance(conv.residual_norm, np.ndarray)
    assert conv.residual_norm.max() < 1e-8
    assert Convergence().num_iterations is None


def test_record_and_stream_loggers():
    A = _spd(seed=5)
    buf = io.StringIO()
    with capture(Record(), Stream(buf)) as (rec, _):
        M = Cg.build(criteria=Iteration(100) | ResidualNorm(1e-8)
                     ).generate(A)
        M.apply(_ones())
    events = [e for e, _ in rec.data]
    assert "linop_factory_generate_started" in events
    assert "linop_factory_generate_completed" in events
    assert "linop_apply_started" in events
    assert "solve_completed" in events
    text = buf.getvalue()
    assert "[ginkgo_tpu_torch] linop_factory_generate_started" in text
    assert all(len(line) < 400 for line in text.splitlines())   # _short


def test_record_ring_and_mask():
    rec = Record(max_storage=2, events_mask={"a", "b"})
    with capture(rec):
        for name in ("a", "b", "c", "a"):
            tlog.dispatch(name, i=1)
    assert [e for e, _ in rec.data] == ["b", "a"]


def test_solver_progress_logger():
    A = _spd(seed=6)
    buf = io.StringIO()
    with capture(SolverProgress(buf)) as prog:
        Cg.solve(A, _ones(), trace=True,
                 criteria=Iteration(100) | ResidualNorm(1e-10))
    assert prog.history is not None
    assert prog.history.shape[0] == 101
    assert "e-" in buf.getvalue()


def test_profiler_hook_summary():
    A = _spd(seed=7)
    with capture(ProfilerHook()) as prof:
        f = Cg.build(criteria=Iteration(50) | ResidualNorm(1e-8))
        op = f.generate(A)
        op.apply(_ones())
        op.apply(_ones())
    summary = prof.create_summary()
    assert any(cnt >= 2 for cnt, _ in summary.values())
    assert summary["Cg"][0] == 1              # one generate
    table = prof.write_summary(io.StringIO())
    assert "| range |" in table and "| Cg | 1 |" in table


def test_annotate_and_trace_to(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace_to(logdir):
        with annotate("ginkgo_test_range"):
            _spd(seed=8).apply(_ones())
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(logdir, files[0])) as f:
        trace = json.load(f)
    assert any(ev.get("name") == "ginkgo_test_range"
               for ev in trace["traceEvents"])


def test_performance_hint():
    A = _spd(seed=8)
    buf = io.StringIO()
    with capture(PerformanceHint(buf, threshold=5)):
        for _ in range(6):
            A.apply(_ones())
    assert buf.getvalue().count("applied 5x one call at a time") == 1


def test_performance_hint_fallback_event():
    buf = io.StringIO()
    with capture(PerformanceHint(buf)):
        for _ in range(2):
            tlog.dispatch(tlog.PERFORMANCE_FALLBACK, kernel="k", reason="r")
    assert buf.getvalue().count("k fell back") == 1


def test_time_criterion_host_loop():
    A = _spd(seed=9)
    res = Cg.solve(A, _ones(),
                   criteria=Iteration(500) | ResidualNorm(1e-10)
                   | Time(time_limit=60.0))
    assert bool(res.converged.all())
    res0 = Cg.solve(A, _ones(),
                    criteria=Iteration(500) | ResidualNorm(1e-14)
                    | Time(time_limit=0.0))
    assert not bool(res0.converged.any())
    assert int(res0.iterations[0]) <= 1


def test_iteration_complete_events_in_host_loop():
    A = _spd(seed=10)
    with capture(Record()) as rec:
        Cg.solve(A, _ones(),
                 criteria=Iteration(20) | ResidualNorm(1e-10)
                 | Time(time_limit=60.0))
    iters = [d for e, d in rec.data if e == "iteration_complete"]
    assert len(iters) >= 1
    checks = [d for e, d in rec.data if e == "criterion_check_completed"]
    assert len(checks) == len(iters)
    assert checks[-1]["num_converged"] >= 1


def test_custom_logger_and_silenced():
    class Count(Logger):
        def __init__(self):
            super().__init__({tlog.SOLVE_COMPLETED})
            self.n = 0

        def on(self, event, **data):
            self.n += 1

    A = _spd(seed=11)
    with capture(Count()) as count:
        Cg.solve(A, _ones(), criteria=Iteration(50) | ResidualNorm(1e-8))
        with tlog.silenced():
            Cg.solve(A, _ones(), criteria=Iteration(50) | ResidualNorm(1e-8))
        assert tlog.has_loggers()
    assert count.n == 1 and not tlog.has_loggers()


def test_convergence_reads_card_tensors_with_cpu():
    """Convergence and SolverProgress read a result built by hand (the
    sinks read its tensors with ``.cpu()``, so card tensors read the
    same)."""
    from ginkgo_tpu_torch.solver.common import SolveResult
    res = SolveResult(x=torch.zeros(3), iterations=torch.tensor([4, 7]),
                      resnorm=torch.tensor([1e-9, 2e-9]),
                      converged=torch.tensor([True, False]),
                      resnorm_history=torch.ones((3, 2)))
    with capture(Convergence(), SolverProgress(io.StringIO())) as (c, p):
        tlog.dispatch(tlog.SOLVE_COMPLETED, result=res)
    assert c.num_iterations == 7 and not c.has_converged()
    assert p.history.shape == (3, 2)


def test_parsed_solver_on_matrix_data_entries():
    """A parsed factory generates on any port operator (here an Ell)."""
    from ginkgo_tpu_torch import Ell
    A = Ell.from_data(MatrixData(*_table_matrix()), device="cpu")
    f = parse({"type": "solver::Cg", "criteria": [
        {"type": "stop::Iteration", "max_iters": 200},
        {"type": "stop::ResidualNorm", "reduction_factor": 1e-10}]})
    x = f.generate(A).apply(_ones(20))
    np.testing.assert_allclose(A.apply(x).numpy(), 1.0, rtol=1e-8)


def _table_matrix():
    d = _data(20, seed=12)
    return d.shape, d.row_idx, d.col_idx, d.values
