"""Run every example of the port on the host and assert its verification
dict, as ``tests/test_examples.py`` does for the JAX package's: a
``converged`` key must be truthy, every ``X`` with an ``X_bound`` is at
most its bound, ``X_low < X < X_high`` where both are given.

Where the example and its JAX counterpart both report an iteration count
or a ``converged`` flag (both in f64), the counterpart runs too: equal
iterations, equal ``converged``, and each bounded metric under its bound
in both.  The other counterparts' bounds are ``tests/test_examples.py``'s.
"""

import contextlib
import importlib.util
import io
import pathlib
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p for p in (REPO / "examples_torch").glob("*.py")
                  if p.stem != "_example_setup")
# the port's name where the JAX example's names JAX or the TPU
COUNTERPART = {"torch_assembly": "jax_assembly",
               "minimal_cuda_solver": "minimal_tpu_solver"}
# both report iterations or converged: held against the JAX example
COMPARED = ("adaptiveprecision_blockjacobi", "batched_solver", "cb_gmres",
            "custom_logger_and_criterion", "custom_matrix_format",
            "external_lib_interfacing", "mixed_precision_ir",
            "multigrid_preconditioned_solver", "poisson_solver",
            "preconditioned_solver", "stencil_solvers", "torch_assembly")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The examples are many small torch ops; under the suite's parallel
    workers the intra-op thread pools oversubscribe the cores, so this
    module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_example(path, **kw):
    """Import ``path`` as a fresh module and return ``main(**kw)``.  Both
    example folders hold an ``_example_setup`` module: the one cached by
    an earlier import is set aside for the run and put back after, with
    ``sys.path``."""
    saved_path = list(sys.path)
    saved_setup = sys.modules.pop("_example_setup", None)
    spec = importlib.util.spec_from_file_location(
        f"ex_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            spec.loader.exec_module(mod)
            assert hasattr(mod, "main"), f"{path.stem} must define main()"
            return mod.main(**kw)
    finally:
        sys.path[:] = saved_path
        sys.modules.pop("_example_setup", None)
        if saved_setup is not None:
            sys.modules["_example_setup"] = saved_setup


def check_contract(name, out):
    assert isinstance(out, dict) and out, (
        f"{name}.main() must return its verification dict")
    checks = 0
    if "converged" in out:
        assert out["converged"], f"{name}: not converged"
        checks += 1
    for key, value in out.items():
        if f"{key}_bound" in out:
            assert value <= out[f"{key}_bound"], (
                f"{name}: {key}={value} exceeds bound "
                f"{out[f'{key}_bound']}")
            checks += 1
        if f"{key}_low" in out and f"{key}_high" in out:
            assert out[f"{key}_low"] < value < out[f"{key}_high"], (
                f"{name}: {key}={value} outside "
                f"({out[f'{key}_low']}, {out[f'{key}_high']})")
            checks += 1
    assert checks >= 1, f"{name}: dict carries no checkable metric"


def test_every_example_is_ported():
    ported = {COUNTERPART.get(p.stem, p.stem) for p in EXAMPLES}
    reference = {p.stem for p in (REPO / "examples").glob("*.py")
                 if p.stem != "_example_setup"}
    assert reference - ported == set()
    assert ported <= reference
    assert len(EXAMPLES) == 24


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_contract(path):
    check_contract(path.stem, run_example(path, device="cpu"))


@pytest.mark.parametrize("stem", COMPARED)
def test_example_matches_reference(stem):
    port = run_example(REPO / "examples_torch" / f"{stem}.py", device="cpu")
    ref = run_example(REPO / "examples" / f"{COUNTERPART.get(stem, stem)}.py")
    assert port.keys() == ref.keys()
    assert "iterations" in port or "converged" in port
    if "iterations" in port:
        assert port["iterations"] == ref["iterations"]
    if "converged" in port:
        assert port["converged"] == ref["converged"]
    for out in (port, ref):
        check_contract(stem, out)


def test_example_needs_a_device(monkeypatch):
    """No ``device``: the card, and a raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        run_example(REPO / "examples_torch" / "simple_solver.py")
