"""The port's benchmark CLI against the JAX package's, suite by suite.

Each suite's ``main(argv)`` runs once in both packages on the same cases
(module-scoped fixtures); the port is given ``-device cpu``.  The JSON
must have the same key tree, the same ``problem``, ``storage`` integer for
integer, the statistics exactly, the generator's files byte for byte, and
the same ``completed``.  Solver iterations may differ by one: the suites
solve in f32, where the two packages' sums run in different orders.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from ginkgo_tpu.benchmark import blas as j_blas
from ginkgo_tpu.benchmark import conversion as j_conversion
from ginkgo_tpu.benchmark import matrix_generator as j_generator
from ginkgo_tpu.benchmark import matrix_statistics as j_statistics
from ginkgo_tpu.benchmark import preconditioner as j_preconditioner
from ginkgo_tpu.benchmark import solver as j_solver
from ginkgo_tpu.benchmark import sparse_blas as j_sparse_blas
from ginkgo_tpu.benchmark import spmv as j_spmv
from ginkgo_tpu_torch.base.exceptions import NotSupportedError
from ginkgo_tpu_torch.benchmark import __main__ as t_main
from ginkgo_tpu_torch.benchmark import blas as t_blas
from ginkgo_tpu_torch.benchmark import conversion as t_conversion
from ginkgo_tpu_torch.benchmark import distributed as t_distributed
from ginkgo_tpu_torch.benchmark import matrix_generator as t_generator
from ginkgo_tpu_torch.benchmark import matrix_statistics as t_statistics
from ginkgo_tpu_torch.benchmark import preconditioner as t_preconditioner
from ginkgo_tpu_torch.benchmark import run_all as t_run_all
from ginkgo_tpu_torch.benchmark import runner as t_runner
from ginkgo_tpu_torch.benchmark import solver as t_solver
from ginkgo_tpu_torch.benchmark import sparse_blas as t_sparse_blas
from ginkgo_tpu_torch.benchmark import spmv as t_spmv

TINY = {"stencil": "5pt", "size": 8}
FEM = {"fem": 4096, "offscale": 1.2}
RCM = {"fem": 3000, "spread": 200, "per_row": 8, "rcm": True}
FAST = ["-repetitions", "1", "-warmup", "1"]


def run_both(jmod, tmod, argv):
    """(reference results, port results), stdout swallowed."""
    with contextlib.redirect_stdout(io.StringIO()):
        ref = jmod.main(list(argv))
        port = tmod.main(list(argv) + ["-device", "cpu"])
    return ref, port


def cases(*cs):
    return ["-input", json.dumps(list(cs))]


# the generate's stage split: present where a stage was bracketed; the
# port brackets every ISAI fill route, the reference only its packed one
STAGE_KEYS = {"device_time", "transfer_time", "host_time", "note"}


def key_tree(obj):
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()
                if k not in STAGE_KEYS}
    if isinstance(obj, list):
        return [key_tree(v) for v in obj]
    return None


def times(obj, path=()):
    """Every number under a key named ``time``."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k == "time":
                yield path + (k,), v
            else:
                yield from times(v, path + (k,))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from times(v, path + (i,))


def completed(results, section):
    return [{name: e["completed"] for name, e in r[section].items()}
            for r in results]


def check_common(ref, port, section):
    assert key_tree(port) == key_tree(ref)
    assert [r["problem"] for r in port] == [r["problem"] for r in ref]
    assert completed(port, section) == completed(ref, section)
    for path, t in times(port):
        assert t > 0, path


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suites' timers widen their chains of small torch ops until the
    signal beats the jitter.  Under the suite's parallel workers the
    intra-op thread pools oversubscribe the cores (the spmv fixture, 10 s
    alone, took 13 min), so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- spmv ------------------------------------------------------------------
@pytest.fixture(scope="module")
def spmv_runs():
    formats = ",".join(t_spmv.ALL_FORMATS + ("bogus",))
    return run_both(j_spmv, t_spmv,
                    cases(TINY, FEM, RCM) + ["-formats", formats] + FAST)


def test_spmv_schema(spmv_runs):
    ref, port = spmv_runs
    # "optimal" names the fastest format: timing, not schema
    strip = [{k: v for k, v in r.items() if k != "optimal"} for r in port]
    check_common([{k: v for k, v in r.items() if k != "optimal"}
                  for r in ref], strip, "spmv")
    for r in port:
        assert r["optimal"]["spmv"] in t_spmv.ALL_FORMATS
        assert r["spmv"]["bogus"] == {"completed": False,
                                      "error": "unknown format 'bogus'"}
    assert all(r["spmv"]["bogus"]["error"] for r in ref)


@pytest.mark.parametrize("fmt", t_spmv.ALL_FORMATS)
@pytest.mark.parametrize("case", range(3), ids=("tiny", "fem", "rcm"))
def test_spmv_storage(spmv_runs, case, fmt):
    ref, port = spmv_runs
    want, got = ref[case]["spmv"][fmt], port[case]["spmv"][fmt]
    assert got["completed"] and want["completed"]
    assert got["storage"] == want["storage"]
    assert got["bandwidth"] == pytest.approx(
        (got["storage"] + 2 * port[case]["problem"]["rows"] * 4)
        / got["time"])


def test_spmv_planned_layouts():
    """The FEM case plans packed in both packages, so ``csr_banded`` is
    counted as classical there (the reference's accounting)."""
    from ginkgo_tpu_torch.benchmark.runner import build_matrix_data
    d = build_matrix_data(FEM)
    A = t_spmv.make_operator("csr_banded", d, device="cpu")
    assert A.strategy == "packed"
    assert t_spmv.storage_bytes("csr_banded", A) == \
        t_spmv.storage_bytes("csr", t_spmv.make_operator("csr", d,
                                                          device="cpu"))


# -- solver ----------------------------------------------------------------
@pytest.fixture(scope="module")
def solver_runs():
    return run_both(j_solver, t_solver,
                    cases(TINY, FEM) + ["-solvers", "cg,bicgstab,gmres,bogus",
                                        "-max_iters", "500",
                                        "-rel_res_goal", "1e-5"] + FAST)


@pytest.fixture(scope="module")
def solver_detailed_runs():
    return run_both(j_solver, t_solver,
                    cases(TINY) + ["-solvers", "cg", "-preconditioner",
                                   "jacobi", "-rel_res_goal", "1e-5",
                                   "-detailed"] + FAST)


def test_solver_schema(solver_runs):
    ref, port = solver_runs
    check_common(ref, port, "solver")
    for r in ref + port:
        assert r["rel_res_goal"] == 1e-5
        assert r["solver"]["bogus"]["completed"] is False
        assert r["solver"]["bogus"]["error"]


@pytest.mark.parametrize("name", ("cg", "bicgstab", "gmres"))
@pytest.mark.parametrize("case", range(2), ids=("tiny", "fem"))
def test_solver_matches_reference(solver_runs, case, name):
    ref, port = solver_runs
    want, got = ref[case]["solver"][name], port[case]["solver"][name]
    assert got["converged"] == want["converged"]
    assert got["solver_reported_converged"] == \
        want["solver_reported_converged"]
    assert abs(got["apply"]["iterations"]
               - want["apply"]["iterations"]) <= 1
    assert got["rhs_norm"] == want["rhs_norm"]
    if want["converged"]:
        for e in (want, got):
            assert e["true_residual_norm"] <= 1e-5 * e["rhs_norm"]
    assert got["dispatch_overhead"] > 0


def test_solver_detailed_history(solver_detailed_runs):
    ref, port = solver_detailed_runs
    check_common(ref, port, "solver")
    want, got = ref[0]["solver"]["cg"], port[0]["solver"]["cg"]
    assert got["converged"] and want["converged"]
    assert abs(len(got["residual_history"])
               - len(want["residual_history"])) <= 1
    assert got["residual_history"][0] == pytest.approx(
        want["residual_history"][0], rel=1e-6)


# -- preconditioner --------------------------------------------------------
PRECONDS = ("jacobi", "block-jacobi", "adaptive-block-jacobi", "ilu",
            "parilu", "parilut", "isai", "gs")


@pytest.fixture(scope="module")
def precond_runs():
    return run_both(j_preconditioner, t_preconditioner,
                    cases(TINY, FEM)
                    + ["-preconditioners", ",".join(PRECONDS + ("bogus",))]
                    + FAST)


def test_preconditioner_schema(precond_runs):
    ref, port = precond_runs
    check_common(ref, port, "preconditioner")
    for r in ref + port:
        assert r["preconditioner"]["bogus"]["completed"] is False


@pytest.mark.parametrize("name", PRECONDS)
def test_preconditioner_entries(precond_runs, name):
    ref, port = precond_runs
    for case in range(2):
        want = ref[case]["preconditioner"][name]
        got = port[case]["preconditioner"][name]
        assert got["completed"] and want["completed"], (got, want)
        assert set(want["generate"]) <= set(got["generate"])
        if "device_time" in got["generate"]:
            g = got["generate"]
            assert min(g["device_time"], g["transfer_time"],
                       g["host_time"]) >= 0
        assert got["apply"]["time"] > 0


# -- blas, sparse_blas, conversion -----------------------------------------
def test_blas_matches_reference():
    argv = ["-input", json.dumps([{"n": 4096, "r": 2}]),
            "-operations", "axpy,scal,dot,norm2,copy,bogus"]
    ref, port = run_both(j_blas, t_blas, argv)
    assert key_tree(port) == key_tree(ref)
    assert port[0]["problem"] == ref[0]["problem"] == {"n": 4096, "r": 2}
    assert completed(port, "blas") == completed(ref, "blas")
    for op in t_blas.OPS:
        e = port[0]["blas"][op]
        assert e["bandwidth"] == pytest.approx(
            t_blas.BYTES_PER_ELEMENT[op] * 4096 * 2 * 4 / e["time"])


@pytest.mark.parametrize("op", t_blas.OPS)
def test_blas_chain_bodies(op):
    """A chain of K bodies equals K applications written out: the
    dependency the timer relies on is real."""
    x = torch.linspace(0.5, 1.5, 64, dtype=torch.float64)[:, None]
    y = torch.full((64, 1), 0.5, dtype=torch.float64)
    z, acc = y, 0.0
    for i in range(3):
        if op == "axpy":
            z = x * (1.0 + 1e-9 * i) + z
        elif op == "scal":
            z = z * (1.0 + 1e-9 * i)
        elif op == "copy":
            z = torch.roll(z, 1 + i, dims=0)
        else:
            d = (x * z).sum(0) if op == "dot" else z.norm(dim=0)
            z = z * (1.0 + 1e-12 * d.sum())
            acc = acc + float(d.sum())
    want = acc if op in ("dot", "norm2") else float(z.sum())
    assert float(t_blas._chain(op, 3)(x, y)) == pytest.approx(want,
                                                              rel=1e-14)


def test_sparse_blas_matches_reference():
    ref, port = run_both(j_sparse_blas, t_sparse_blas,
                         cases(TINY) + ["-operations",
                                        "spgemm,spgemm_device,spgeam,"
                                        "transpose,bogus"] + FAST)
    check_common(ref, port, "sparse_blas")
    assert all(port[0]["sparse_blas"][op]["completed"]
               for op in t_sparse_blas.OPS)


def test_conversion_matches_reference():
    ref, port = run_both(j_conversion, t_conversion,
                         cases(TINY, FEM) + ["-conversions",
                                             "data-csr,data-ell,csr-ell,"
                                             "csr-hybrid,coo-sellp,"
                                             "data-bogus"] + FAST)
    check_common(ref, port, "conversion")
    assert port[0]["conversion"]["csr-hybrid"]["completed"]
    assert not port[0]["conversion"]["data-bogus"]["completed"]


# -- statistics and generator ----------------------------------------------
def test_matrix_statistics_equal():
    argv = cases(TINY, FEM, RCM, {"stencil": "27pt", "size": 6},
                 {"fem": 2000, "sym": True})
    ref, port = run_both(j_statistics, t_statistics, argv)
    assert port == ref


def test_matrix_generator_files_identical(tmp_path):
    cfg = (("bd", {"type": "block-diagonal", "num_blocks": 7,
                   "block_size": 5}),
           ("st", {"type": "stencil", "stencil": "9pt", "size": 9}),
           ("rd", {"type": "random", "rows": 50, "cols": 60,
                   "nonzeros_per_row": [1, 5]}),
           ("rs", {"type": "random", "rows": 40, "cols": 40, "seed": 7}))
    outs = {}
    for pkg, mod, extra in (("ref", j_generator, []),
                            ("port", t_generator, ["-device", "cpu"])):
        conf = [{"filename": str(tmp_path / f"{pkg}_{tag}.mtx"),
                 "problem": p} for tag, p in cfg]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(["-input", json.dumps(conf), "-seed", "11"] + extra)
        outs[pkg] = json.loads(buf.getvalue())
    for tag, _ in cfg:
        assert (tmp_path / f"port_{tag}.mtx").read_bytes() == \
            (tmp_path / f"ref_{tag}.mtx").read_bytes(), tag
    assert [o["problem"] for o in outs["port"]] == \
        [o["problem"] for o in outs["ref"]]


# -- runner, dispatch, run_all, distributed ----------------------------------
def test_runner_helpers():
    assert t_runner.chain_k_for_backend("cuda") == (2, 8)
    assert t_runner.chain_k_for_backend("cpu") == (2, 8)
    assert t_runner.chain_k_for_backend("tpu") == (8, 32)
    for case in (TINY, FEM, RCM, {"filename": "a.mtx", "rcm": True}):
        from ginkgo_tpu.benchmark import runner as j_runner
        assert t_runner.case_name(case) == j_runner.case_name(case)
    calls = []

    def make_chain(K):
        def f(z):
            calls.append(K)
            return torch.ones(()) * K
        return f
    t = t_runner.time_chained(make_chain, (None,), 2, 8)
    assert t > 0 and {2, 8} <= set(calls)
    assert t_runner.time_blocking(lambda: None, warmup=0, reps=2,
                                  device="cpu") >= 0
    assert t_runner.dispatch_overhead("cpu") > 0


def test_main_dispatch(capsys):
    assert t_main.main([]) == 2
    assert t_main.main(["bogus"]) == 2
    assert "usage" in capsys.readouterr().err
    assert t_main.main(["matrix_statistics", "-input",
                        json.dumps([TINY]), "-device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out[0]["row_distribution"]["max"] == 5
    from ginkgo_tpu.benchmark import __main__ as j_main
    assert t_main.SUITES == j_main.SUITES


def test_run_all_writes_every_suite(tmp_path):
    suites = ("spmv", "solver", "preconditioner", "blas", "sparse_blas",
              "conversion", "matrix_statistics")
    assert t_run_all.main(["-outdir", str(tmp_path), "-size", "4",
                           "-device", "cpu"]) == 0
    for suite in suites:
        res = json.loads((tmp_path / f"{suite}.json").read_text())
        assert res, suite
        for r in res:
            for section, entries in r.items():
                if section in ("problem", "optimal", "rel_res_goal",
                               "row_distribution", "bandwidth"):
                    continue
                for name, e in entries.items():
                    assert e["completed"], (suite, name, e)


def test_distributed_raises_naming_the_queue_item():
    """The suite's parts share one device; parts named on two devices
    are the multi-card item, which raises."""
    from ginkgo_tpu_torch.distributed import Mesh, Partition, read_distributed
    from ginkgo_tpu_torch.utils.generators import stencil_3d
    two = Mesh(np.array([torch.device("cpu"), torch.device("meta")]),
               ("rows",))
    with pytest.raises(NotSupportedError, match="queue 1 item 14"):
        read_distributed(stencil_3d(4, 4, 8, points=27),
                         Partition.build_from_global_size_uniform(2, 128),
                         two)


def test_distributed_key_tree():
    """The weak-scaling entries: the reference's keys, rows and nonzeros
    (the reference on its 8 virtual CPU devices, the port's parts on the
    host, ``device_pool`` saying so)."""
    from ginkgo_tpu.benchmark import distributed as j_distributed
    argv = ["-devices", "1,2,4", "-base_edge", "6", "-comm",
            "neighborhood"] + FAST
    ref, port = run_both(j_distributed, t_distributed, argv)
    assert [sorted(e) for e in port] == [sorted(e) for e in ref]
    for r, t in zip(ref, port):
        assert {k: t[k] for k in ("devices", "rows", "nonzeros", "comm")} \
            == {k: r[k] for k in ("devices", "rows", "nonzeros", "comm")}
        assert t["time"] > 0 and t["nnz_per_s"] > 0
        assert t["device_pool"] == f"cpu (all {t['devices']} parts on one " \
            "device)"
    assert port[0]["weak_scaling_efficiency"] == 1.0


def test_suites_need_a_device(monkeypatch):
    """No ``-device``: the card, and a raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (t_spmv, t_solver, t_preconditioner, t_blas, t_sparse_blas,
                t_conversion, t_statistics, t_distributed):
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            mod.main(cases(TINY))
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        t_generator.main(["-input", "[]"])
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        t_run_all.main(["-outdir", "unused"])
