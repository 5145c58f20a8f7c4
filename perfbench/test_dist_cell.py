"""CPU tests of the four-card cell ``hpcg27-dist-cg-16rhs-4card``: its
look-up by name, its system (``systems/dist_krylov.py``) over 2 gloo ranks
at a 16^3 grid judged by the harness's own check, and ``run.py``'s refusal
on a machine with fewer cards than the cell asks for.

    python -m pytest perfbench/test_dist_cell.py
"""

import json
import math
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import harness, run, spec  # noqa: E402

CELL = "hpcg27-dist-cg-16rhs-4card"
METRICS = ("solve_ms.4card", "iter_ms.4card", "dispatch_ms_per_iter.4card",
           "exchange_ms_per_iter.4card", "allreduce_ms_per_iter.4card",
           "exchange_bytes_per_iter.4card", "allreduces_per_iter.4card",
           "ops_per_iter.4card", "host_reads_per_iter.4card",
           "precond_ms_per_iter.4card")
# kernel A's launches are counted on a card alone (the host runs the plain
# version)
CARD_ONLY = ("dia_wide_launches_per_spmv.4card",)
SEED = 2**33 + 29


@pytest.fixture
def one_thread(monkeypatch):
    """Every rank on one torch thread (the followers read
    ``OMP_NUM_THREADS`` when they start): more oversubscribe the host's
    cores under the test workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cell_is_found_by_name():
    c = spec.load_cell(ROOT, CELL)
    assert c.chips == 4 and c.config["system"] == "dist_krylov"
    assert c.config["ranks"] == c.config["parts"] == 4
    assert set(c.metrics) == {"setup_s", "peak_mem_gib"}
    assert set(METRICS + CARD_ONLY) <= set(c.trace_metrics)
    assert all(c.trace_metrics[m]["moves"] == "peak_mem_gib"
               for m in METRICS + CARD_ONLY)
    assert c.trace_metrics["from_data_s.4card"]["moves"] == "setup_s"


def small_root(tmp_path):
    """The benchmark with the cell's configuration at 16^3 over 2 gloo
    ranks on the host."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    f = root / "perfbench" / "configs" / "hpcg27-dist-jacobi-cg.json"
    config = json.loads(f.read_text())
    config.update(nx=16, ny=16, nz=16, ranks=2, parts=2, backend="gloo")
    f.write_text(json.dumps(config))
    return root


def test_two_gloo_ranks_give_the_references_answers(tmp_path, one_thread):
    """The whole run, traced, over 2 ranks: every sampled solve passes the
    harness's check against the plain f64 reference, and the per-layer
    metrics read the program's spans and counters (on the host here, so
    their times are no device's)."""
    result = harness.run_cell(small_root(tmp_path), CELL, SEED, 0.3, True,
                              "cpu", time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"]["x_gap"]["value"] < 1e-5
    got = result["metrics"]
    assert set(got) == set(METRICS) | {"from_data_s.4card"}
    assert all(math.isfinite(got[m]["value"]) for m in got)
    # 2 ranks, one part each: rank 0 sends its 16 x 16 boundary plane of
    # 16 f32 columns an SpMV, one SpMV an iteration plus the start's
    plane = 16 * 16 * 16 * 4
    assert plane <= got["exchange_bytes_per_iter.4card"]["value"] \
        < 1.2 * plane
    assert 2 <= got["allreduces_per_iter.4card"]["value"] <= 4


def test_run_needs_the_cells_cards(monkeypatch, capsys):
    """On a machine with one card the run exits 1 before any set-up, with
    no result line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", pytest.fail)
    assert run.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "needs 4 CUDA card(s)" in out.err
