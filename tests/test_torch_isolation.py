"""The port stands alone: importing ``ginkgo_tpu_torch`` loads neither JAX
nor any module of ``ginkgo_tpu``, its source names neither, and its entry
points place their tensors on the CUDA device unless the caller asks for
the host."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import ginkgo_tpu_torch as gtt
from ginkgo_tpu_torch import device as port_device
from ginkgo_tpu_torch.interop import csr_from_arrays
from ginkgo_tpu_torch.utils.generators import stencil_3d

PKG = pathlib.Path(gtt.__file__).resolve().parent
REPO = PKG.parent


def test_import_loads_no_jax():
    code = ("import sys; import ginkgo_tpu_torch, ginkgo_tpu_torch.solver, "
            "ginkgo_tpu_torch.preconditioner, ginkgo_tpu_torch.interop, "
            "ginkgo_tpu_torch.ops._cuda, ginkgo_tpu_torch.factorization, "
            "ginkgo_tpu_torch.native, ginkgo_tpu_torch.benchmark, "
            "ginkgo_tpu_torch.base.mtx_io, ginkgo_tpu_torch.matrix.ell, "
            "ginkgo_tpu_torch.matrix.hybrid, ginkgo_tpu_torch.matrix.sellp, "
            "ginkgo_tpu_torch.matrix.fbcsr, ginkgo_tpu_torch.matrix.fft, "
            "ginkgo_tpu_torch.matrix.sparsity_csr, "
            "ginkgo_tpu_torch.matrix.fastpath, "
            "ginkgo_tpu_torch.matrix.permutation, "
            "ginkgo_tpu_torch.matrix.row_gatherer, "
            "ginkgo_tpu_torch.matrix.csr_lookup, "
            "ginkgo_tpu_torch.matrix.dense, "
            "ginkgo_tpu_torch.base.composition, "
            "ginkgo_tpu_torch.reorder, ginkgo_tpu_torch.ops.spgemm, "
            "ginkgo_tpu_torch.ops.components, "
            "ginkgo_tpu_torch.ops.device_matrix_data, "
            "ginkgo_tpu_torch.factorization.direct, "
            "ginkgo_tpu_torch.solver.direct, "
            "ginkgo_tpu_torch.preconditioner.isai, "
            "ginkgo_tpu_torch.preconditioner.sor, "
            "ginkgo_tpu_torch.multigrid, ginkgo_tpu_torch.multigrid.pgm_dia, "
            "ginkgo_tpu_torch.multigrid.pgm_packed, "
            "ginkgo_tpu_torch.solver.multigrid, "
            "ginkgo_tpu_torch.base.precision, "
            "ginkgo_tpu_torch.base.accessor, ginkgo_tpu_torch.ops.df64, "
            "ginkgo_tpu_torch.ops.dc64, ginkgo_tpu_torch.batch, "
            "ginkgo_tpu_torch.autodiff, ginkgo_tpu_torch.config, "
            "ginkgo_tpu_torch.log, ginkgo_tpu_torch.log.profiler_hook, "
            "ginkgo_tpu_torch.utils, ginkgo_tpu_torch.utils.checkpoint, "
            "ginkgo_tpu_torch.utils.export, "
            "ginkgo_tpu_torch.utils.compile_cache, "
            "ginkgo_tpu_torch.benchmark.__main__, "
            "ginkgo_tpu_torch.benchmark.spmv, "
            "ginkgo_tpu_torch.benchmark.solver, "
            "ginkgo_tpu_torch.benchmark.preconditioner, "
            "ginkgo_tpu_torch.benchmark.blas, "
            "ginkgo_tpu_torch.benchmark.sparse_blas, "
            "ginkgo_tpu_torch.benchmark.conversion, "
            "ginkgo_tpu_torch.benchmark.matrix_statistics, "
            "ginkgo_tpu_torch.benchmark.matrix_generator, "
            "ginkgo_tpu_torch.benchmark.run_all, "
            "ginkgo_tpu_torch.benchmark.distributed, "
            "ginkgo_tpu_torch.distributed, "
            "ginkgo_tpu_torch.distributed.launch, "
            "ginkgo_tpu_torch.distributed.mesh, "
            "ginkgo_tpu_torch.distributed.vector, "
            "ginkgo_tpu_torch.multigrid.distributed_pgm, "
            "ginkgo_tpu_torch.base.collections; "
            "sys.path.insert(0, 'tests'); import rank_cases; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'ginkgo_tpu' "
            "or m.startswith('ginkgo_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_source_names_no_jax_import():
    files = (sorted(PKG.rglob("*.py"))
             + sorted((REPO / "examples_torch").glob("*.py"))
             + [REPO / name for name in ("chip_smoke.py", "bench_torch.py",
                                         "graft_entry_torch.py",
                                         "tools/torch_multicard_probe.py",
                                         "tests/rank_cases.py")])
    assert len(files) > 20
    assert sum(p.parent.name == "examples_torch" for p in files) == 25
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "ginkgo_tpu"), (path, mod)
        text = path.read_text()
        assert "import jax" not in text, path
        assert "from ginkgo_tpu " not in text and \
            "from ginkgo_tpu." not in text, path


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(monkeypatch):
    d = stencil_3d(4, points=7)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        gtt.Csr.from_data(d)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        csr_from_arrays({}, {"shape": d.shape})
    from ginkgo_tpu_torch.factorization import Lu
    from ginkgo_tpu_torch.ops.spgemm import spgemm_data
    from ginkgo_tpu_torch.base.accessor import (ReducedRowMajor,
                                                ScaledReducedRowMajor)
    from ginkgo_tpu_torch.multigrid import Pgm
    from ginkgo_tpu_torch.ops.dc64 import dc_from_c64
    from ginkgo_tpu_torch.preconditioner import Isai, Sor
    from ginkgo_tpu_torch.solver import Multigrid
    from ginkgo_tpu_torch.benchmark import spmv
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "ex_isolation_simple_solver",
        REPO / "examples_torch" / "simple_solver.py")
    example = importlib.util.module_from_spec(spec)
    saved_path, saved_setup = list(sys.path), sys.modules.pop(
        "_example_setup", None)
    try:
        spec.loader.exec_module(example)
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            example.main()
    finally:
        sys.path[:] = saved_path
        sys.modules.pop("_example_setup", None)
        if saved_setup is not None:
            sys.modules["_example_setup"] = saved_setup
    for entry in (lambda: spmv.main(["-input", '[{"stencil": "5pt", '
                                               '"size": 4}]']),
                  lambda: gtt.Diagonal.from_data(d),
                  lambda: Pgm().generate(d),
                  lambda: Multigrid.build().generate(d),
                  lambda: ReducedRowMajor.create((2, 2), torch.float16),
                  lambda: ScaledReducedRowMajor.create((2, 2)),
                  lambda: dc_from_c64(np.ones(3, np.complex64)),
                  lambda: Lu().generate(d), lambda: Isai().generate(d),
                  lambda: Sor().generate(d),
                  lambda: spgemm_data(d, d, numeric="device")):
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            entry()
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    A = gtt.Csr.from_data(d, device="cpu")
    assert A.device.type == "cpu" and A.diag_values.device.type == "cpu"


def test_default_device_is_cuda_when_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_device.resolve_device(None) == torch.device("cuda")


def test_failed_build_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    """Importing the package built nothing; a build whose nvcc fails
    raises with the compiler's own message and leaves no library."""
    from ginkgo_tpu_torch.ops import _cuda
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: fake compiler refused' >&2\n"
                    "exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="fake compiler refused"):
        _cuda.build(("dia_spmv", "sell_spmv"))
    assert not list((tmp_path / "kernels").glob("*.so"))
    for name in _cuda.SIGNATURES:
        assert (_cuda.SRC_DIR / f"{name}.cu").exists()


def test_type_codes_match_sources():
    from ginkgo_tpu_torch.ops import _cuda
    for name in _cuda.SIGNATURES:
        src = (_cuda.SRC_DIR / f"{name}.cu").read_text()
        assert "enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };" \
            in src
        for entry in _cuda.SIGNATURES[name]:
            assert f'extern "C" int {entry}(' in src
    assert [_cuda.type_code(t) for t in (torch.float32, torch.float64,
                                         torch.bfloat16, torch.float16)] \
        == [0, 1, 2, 3]
    # the complex codes of the SpMV kernels' complex instantiations
    for name in ("dia_spmv", "sell_spmv"):
        src = (_cuda.SRC_DIR / f"{name}.cu").read_text()
        assert "enum ComplexTypeCode { kC64 = 4, kC128 = 5 };" in src
    assert [_cuda.type_code(t) for t in (torch.complex64,
                                         torch.complex128)] == [4, 5]
