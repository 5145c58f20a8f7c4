"""CPU tests of the benchmark harness at small grids: the result line, the
look-up of cells, configurations and metrics by name, the JAX guard, the
trace reader, and the check failing on planted faults and on the control.

    python -m pytest perfbench/

The harness itself always runs on the card; these tests pass ``"cpu"``
to its internal functions.  ``test_run_on_card`` needs the card and skips
without one.
"""

import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import calibrate, check, harness, profile, run, spec  # noqa: E402
from perfbench.matrices import hpcg27  # noqa: E402
from perfbench.reference import krylov  # noqa: E402

CELLS = ("hpcg27-cg-1rhs", "hpcg27-gmres100-1rhs", "hpcg27-cg-16rhs")
SEED = 2**33 + 17


def small_root(tmp_path, nx):
    """A checkout's benchmark (BENCHMARK.json and perfbench/) with every
    configuration's grid cut to nx^3."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    for f in (root / "perfbench" / "configs").glob("*.json"):
        config = json.loads(f.read_text())
        config.update(nx=nx, ny=nx, nz=nx)
        f.write_text(json.dumps(config))
    return root


def run_small(root, cell, trace=False, seconds=0.3):
    return harness.run_cell(root, cell, SEED, seconds, trace, "cpu",
                            time.perf_counter())


@pytest.fixture(scope="module")
def root8(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("r8"), 8)


def test_generator_is_hpcg():
    (n, _), rows, cols, values = hpcg27.generate({"nx": 5, "ny": 4,
                                                  "nz": 3})
    assert n == 60 and len(values) == 13 * 10 * 7
    assert np.all(np.diff(rows) >= 0)
    assert np.all(values[rows == cols] == 26)
    assert np.all(values[rows != cols] == -1)
    dense = np.zeros((n, n))
    dense[rows, cols] = values
    assert np.array_equal(dense, dense.T)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_required_keys(root8, cell, trace):
    result = run_small(root8, cell, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + [
        "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    c = spec.load_cell(root8, cell)
    wanted = c.trace_metrics if trace else c.metrics
    # only a card gives peak memory, the roofline and the device's idle time
    on_card = ("peak_mem_gib", "spmv_roofline", "spmv_roofline.1rhs",
               "device_idle_pct")
    assert set(result["metrics"]) == {
        n for n in wanted if n not in on_card}
    for name, metric in result["metrics"].items():
        assert metric["unit"] == wanted[name]["unit"]
        assert math.isfinite(metric["value"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(result["checks"]) == {"failed", "relres", "x_gap"}
    json.loads(json.dumps(result))


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as files,
    with entries in BENCHMARK.json, run with no edit to any file."""
    root = small_root(tmp_path, 6)
    here = root / "perfbench"
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in here.rglob("*") if p.is_file()}
    config = json.loads((here / "configs" / "hpcg27-jacobi-cg.json")
                        .read_text())
    config.update(nx=7, ny=5, nz=6, preconditioner=None)
    (here / "configs" / "box-cg.json").write_text(json.dumps(config))
    (here / "traffic" / "rhs3-ones.json").write_text(json.dumps(
        {"columns": 3, "entries": "ones", "loop": "closed"}))
    (here / "workloads" / "box-cg-3rhs.json").write_text(json.dumps(
        {"sample": 2, "limits": {"x_gap": 1e-4}}))
    (here / "metrics" / "solves_seen.py").write_text(
        "def read(run):\n    return float(len(run.solves))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "box-cg", "source": "test",
                             "file": "perfbench/configs/box-cg.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "box-cg-3rhs", "config": "box-cg",
                               "traffic": "rhs3-ones", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "solves_seen", "unit": "solves",
                               "better": "higher", "source": "host_clock",
                               "layer": "solvers", "moves": "solve_ms",
                               "workloads": ["box-cg-3rhs"]})
    solve_ms = next(m for m in bench["end_to_end"] if m["name"] == "solve_ms")
    solve_ms["workloads"].append("box-cg-3rhs")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run_small(root, "box-cg-3rhs", trace=True)
    assert result["correct"] is True
    assert result["metrics"]["solves_seen"]["value"] == result["attempted"]
    assert "solves_seen" not in run_small(root, CELLS[0], True)["metrics"]
    for p, digest in before.items():
        assert hashlib.sha256(p.read_bytes()).hexdigest() == digest


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    c = spec.load_cell(ROOT, cell)
    assert "setup_s" in c.metrics and len(c.metrics) >= 2
    assert c.trace_metrics


@pytest.mark.parametrize("metric", [m["name"] for m in _bench()["per_layer"]])
def test_per_layer_metric_moves_a_metric_its_cells_report(metric):
    """Every cell that a per-layer metric lists reports the end-to-end
    metric it moves, and its reader is found by its name."""
    entry = next(m for m in _bench()["per_layer"] if m["name"] == metric)
    for cell in entry["workloads"]:
        c = spec.load_cell(ROOT, cell)
        assert metric in c.trace_metrics and entry["moves"] in c.metrics
        assert callable(c.reader(metric))


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(["ginkgo_tpu_torch", "ginkgo_tpu_torch.ops",
                                  "jax_like", "numpy"]) == []
    assert run.forbidden_modules(["ginkgo_tpu.solver", "jaxlib.xla",
                                  "flax", "jax"]) == ["flax", "ginkgo_tpu",
                                                      "jax", "jaxlib"]


def test_harness_loads_neither_jax_nor_the_jax_package(root8):
    code = ("import sys, time; sys.path.insert(0, sys.argv[1]);"
            "from perfbench import harness, run;"
            "harness.run_cell(sys.argv[2], 'hpcg27-cg-1rhs', 3, 0.1, True, "
            "'cpu', time.perf_counter());"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(root8)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("only_the_benchmark", [False, True])
def test_run_without_a_card_or_the_program_prints_nothing(tmp_path,
                                                          only_the_benchmark):
    cwd = ROOT
    if only_the_benchmark:
        cwd = tmp_path / "bare"
        shutil.copytree(ROOT / "perfbench", cwd / "perfbench")
        shutil.copy(ROOT / "BENCHMARK.json", cwd)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def test_trace_summary_reads_busy_time_and_labels_gaps():
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [ev("user_annotation", "solve", 0, 100),
              ev("user_annotation", "rhs", 100, 10),
              ev("user_annotation", "solve", 110, 90),
              ev("cpu_op", "aten::item", 20, 30),
              ev("kernel", "dia_spmv", 5, 15),
              ev("kernel", "dia_spmv", 10, 10),
              ev("gpu_memcpy", "Memcpy DtoH", 60, 50),
              ev("kernel", "dot", 150, 60)]
    out = profile.summarize(events)
    assert out["window_s"] == pytest.approx(200e-6)
    assert out["busy_s"] == pytest.approx((15 + 50 + 50) * 1e-6)
    assert out["device_ops"][0] == ["Memcpy DtoH", pytest.approx(50e-6)]
    gaps = dict(out["idle_gaps"])
    assert gaps["solve/aten::item"] == pytest.approx(40e-6)
    assert gaps["solve"] == pytest.approx((5 + 40) * 1e-6)
    assert sum(gaps.values()) == pytest.approx(85e-6)


def test_reservoir_draws_from_the_seed():
    def draw(seed, count):
        r = check.Reservoir(3, seed)
        for i in range(count):
            r.offer(i, i)
        return sorted(r.items)

    assert draw(5, 40) == draw(5, 40)
    assert draw(5, 2) == [0, 1]
    assert len(draw(5, 40)) == 3
    assert len({tuple(draw(s, 40)) for s in range(8)}) > 1


def _plant(monkeypatch, fault):
    """Break the program's solvers underneath the timed path."""
    from ginkgo_tpu_torch.solver import cg, gmres

    if fault == "state_unchanged":
        for mod, loop in ((cg, "run_iteration_loop"),
                          (gmres, "run_restarted_loop")):
            orig = getattr(mod, loop)
            monkeypatch.setattr(mod, loop, (
                lambda orig: lambda step, *a, **kw:
                orig(lambda s, active: s, *a, **kw))(orig))
    elif fault == "half_the_block":
        orig = cg.prepare_rhs

        def half(A, b, x0):
            b2, x2, squeeze = orig(A, b, x0)
            b2 = b2.clone()
            b2[:, b2.shape[1] // 2:] = 0
            return b2, x2, squeeze

        monkeypatch.setattr(cg, "prepare_rhs", half)
    elif fault == "answer_altered":
        for mod in (cg, gmres):
            orig = mod.finish

            def altered(final, history, x, r, squeeze, orig=orig):
                x = x.clone()
                x[x.shape[0] // 2] += 1e-2 * x.abs().max()
                return orig(final, history, x, r, squeeze)

            monkeypatch.setattr(mod, "finish", altered)


@pytest.mark.parametrize("cell,fault", [
    ("hpcg27-cg-1rhs", "state_unchanged"),
    ("hpcg27-gmres100-1rhs", "state_unchanged"),
    ("hpcg27-cg-16rhs", "half_the_block"),
    ("hpcg27-cg-1rhs", "answer_altered"),
    ("hpcg27-gmres100-1rhs", "answer_altered"),
    ("hpcg27-cg-16rhs", "answer_altered"),
])
def test_check_fails_on_a_planted_fault(root8, monkeypatch, cell, fault):
    _plant(monkeypatch, fault)
    result = run_small(root8, cell, seconds=0.05)
    assert result["correct"] is False


@pytest.mark.parametrize("cell,nx", [("hpcg27-cg-1rhs", 24),
                                     ("hpcg27-gmres100-1rhs", 40),
                                     ("hpcg27-cg-16rhs", 16)])
def test_control_fails_and_the_program_passes(tmp_path, cell, nx):
    """The plain reference one precision step down (bf16 for CG, TF32 for
    GMRES) in the program's place comes out not correct; the program, on
    the same seeds, correct."""
    c = spec.load_cell(small_root(tmp_path, nx), cell)
    for control in (False, True):
        for seed, rows in calibrate.readings(c, [SEED, SEED + 1], "cpu",
                                             control=control).items():
            assert check.verdict(
                [(n, v, lim) for n, (v, lim) in rows.items()]) is not control


def test_reference_follows_the_program_to_its_iteration_count():
    matrix = hpcg27.generate({"nx": 10, "ny": 10, "nz": 10})
    op = krylov.operator(matrix, "cpu")
    b = torch.randn((1000, 2), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    config = {"solver": "cg", "preconditioner": "jacobi", "tol": 1e-6,
              "max_iters": 500}
    full = krylov.solve(op, b, config, "float64")
    at = krylov.solve(op, b, config, "float64", snapshot=[3, 5])
    again = krylov.solve(op, b, {**config, "max_iters": 5}, "float64")
    assert torch.equal(at.iterations, full.iterations)
    assert torch.allclose(at.x[:, 1], again.x[:, 1], rtol=0, atol=1e-14)
    assert float(krylov.true_relres(op, b, full.x).max()) <= 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_run_on_card(card):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          CELLS[0], "--seed", "11", "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is True
