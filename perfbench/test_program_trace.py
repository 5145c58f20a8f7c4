"""CPU tests of ``program_trace.py``'s parsers on hand-written traces: ops an
iteration, device time given to the span that launched it, the idle time
by span, and the host pass's numbers from a recording.

    python -m pytest perfbench/
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ginkgo_tpu_torch.log import Span  # noqa: E402
from perfbench import program_trace  # noqa: E402


def ev(cat, name, ts, dur, corr=None):
    out = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
           "pid": 1, "tid": 1}
    if corr is not None:
        out["args"] = {"correlation": corr}
    return out


EVENTS = [
    # the first solve: two iterations
    ev("user_annotation", "solver.cg", 0, 100),
    ev("user_annotation", "loop.iteration", 10, 40),
    ev("user_annotation", "step.precond", 12, 8),
    ev("user_annotation", "loop.host_read", 40, 10),
    ev("user_annotation", "loop.iteration", 50, 40),
    ev("cpu_op", "aten::zeros", 2, 3),                  # before the loop
    ev("cpu_op", "aten::mul", 21, 9),
    ev("cpu_op", "aten::to", 22, 3),                    # nested in mul
    ev("cpu_op", "aten::item", 41, 7),
    ev("cpu_op", "aten::add", 55, 5),
    ev("cuda_runtime", "cudaLaunchKernel", 14, 2, corr=7),
    ev("kernel", "jacobi", 30, 5, corr=7),              # runs under mul
    ev("cuda_runtime", "cudaMemcpyAsync", 41, 1, corr=9),
    ev("gpu_memcpy", "Memcpy DtoH", 42, 2, corr=9),
    ev("cuda_runtime", "cudaLaunchKernel", 56, 1, corr=8),
    ev("kernel", "dia_spmv", 60, 20, corr=8),
    ev("cuda_runtime", "cudaLaunchKernel", 92, 1, corr=11),
    ev("kernel", "norm", 95, 10, corr=11),              # after the loop
    # the second solve, after a gap outside any span
    ev("user_annotation", "solver.cg", 120, 30),
    ev("cuda_driver", "cuLaunchKernel", 121, 1, corr=10),
    ev("kernel", "norm", 130, 20, corr=10),
]


def test_ops_and_device_time_by_launching_span():
    out = program_trace.summarize(EVENTS)
    assert out["iterations"] == 2
    # mul and item in the first iteration, add in the second
    assert out["ops_per_iter"] == pytest.approx(1.5)
    device = out["device_s"]
    assert device["step.precond"] == pytest.approx(5e-6)
    assert device["loop.host_read"] == pytest.approx(2e-6)
    assert device["loop.iteration"] == pytest.approx(20e-6)
    assert device["solver.cg"] == pytest.approx(30e-6)
    assert sum(device.values()) == pytest.approx(57e-6)


def test_idle_time_by_span_and_its_line():
    out = program_trace.summarize(EVENTS)
    assert out["window_s"] == pytest.approx(150e-6)
    assert out["busy_s"] == pytest.approx(57e-6)
    # each gap goes to the span open where it began: [0, 30) the solve,
    # [35, 42) and [80, 95) an iteration, [44, 60) the host read, and
    # [105, 130) no span
    idle = out["idle_s"]
    assert set(idle) == {"solver.cg", "loop.iteration", "between",
                         "loop.host_read"}
    assert idle["solver.cg"] == pytest.approx(30e-6)
    assert idle["loop.iteration"] == pytest.approx(22e-6)
    assert idle["between"] == pytest.approx(25e-6)
    assert idle["loop.host_read"] == pytest.approx(16e-6)
    line = program_trace.idle_line(out)
    assert "idle s by span: solver.cg 0.000030, between 0.000025, " \
           "loop.iteration 0.000022, loop.host_read 0.000016" in line
    assert "busy ms an iteration 0.0285" in line
    assert "1.50 ops an iteration" in line


def test_device_is_host_gives_each_span_its_own_duration():
    out = program_trace.summarize(EVENTS, device_is_host=True)
    assert out["device_s"]["step.precond"] == pytest.approx(8e-6)
    assert out["device_s"]["loop.iteration"] == pytest.approx(80e-6)
    assert "idle_s" not in out


def test_no_iteration_spans_give_nothing():
    assert program_trace.summarize(
        [e for e in EVENTS if e["name"] != "loop.iteration"]) == {}


def test_host_summary_takes_the_reads_out_of_each_iteration():
    ms = 1_000_000
    spans = [Span(0, None, 0, "solver.cg", 0, 20 * ms),
             Span(1, 0, 0, "loop.iteration", 1 * ms, 5 * ms),
             Span(2, 1, 0, "loop.host_read", 4 * ms, 5 * ms),
             Span(3, 0, 0, "loop.iteration", 5 * ms, 11 * ms),
             Span(4, 3, 0, "loop.host_read", 8 * ms, 11 * ms),
             Span(5, 0, 0, "loop.host_read", 0, 1 * ms),
             Span(6, None, None, "loop.iteration", 30 * ms, 40 * ms)]
    out = program_trace.host_summary(spans, {"host_reads": 3})
    assert out["iterations"] == 2        # the one outside a solve is not
    assert out["host_reads_per_iter"] == pytest.approx(1.5)
    assert out["dispatch_ms_per_iter"] == pytest.approx((3 + 3) / 2)
