"""The port's own entry points on the host: ``bench_torch.py`` in its
explicit CPU mode and ``graft_entry_torch.entry(device="cpu")`` against
the JAX package's ``__graft_entry__.entry()``."""

import json

import numpy as np
import pytest
import torch

import bench_torch
import graft_entry_torch


def test_bench_prints_one_line_of_the_bench_schema(capsys):
    assert bench_torch.main(["--device", "cpu", "--nx", "8"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline"}
    assert out["metric"].startswith("spmv_27pt_poisson_n512_banded_cpu_stream")
    assert out["unit"] == "GB/s"
    assert out["value"] > 0 and out["vs_baseline"] > 0


def test_bench_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_median_takes_the_middle_of_an_odd_count():
    assert bench_torch.median_of_odd([5.0, 1.0, 3.0]) == 3.0
    assert bench_torch.median_of_odd([2.0, 9.0, 1.0, 7.0, 3.0]) == 3.0
    with pytest.raises(ValueError, match="odd"):
        bench_torch.median_of_odd([1.0, 2.0, 3.0, 4.0])


def test_net_step_time_is_the_median_of_chain_differences(monkeypatch):
    """Each sample is (t(K2) - t(K1)) / (K2 - K1); the result is the middle
    sample of an odd count."""
    chains = iter([1.0, 3.0, 1.0, 9.0, 1.0, 5.0])   # (k1, k2) pairs
    monkeypatch.setattr(bench_torch, "_chain_seconds",
                        lambda step, z0, K, device: next(chains))
    t = bench_torch.net_step_seconds(None, None, 2, 4, torch.device("cpu"),
                                     samples=3)
    assert t == 2.0


def test_storage_bytes_counts_as_bench_does():
    from ginkgo_tpu_torch import Csr
    from ginkgo_tpu_torch.utils.generators import stencil_3d
    A = Csr.from_data(stencil_3d(8, points=27), dtype=np.float32,
                      device="cpu")
    assert A.strategy == "banded"
    assert bench_torch.storage_bytes(A) == A.diag_values.numel() * 4
    C = Csr.from_data(stencil_3d(8, points=27), dtype=np.float32,
                      strategy="classical", device="cpu")
    assert bench_torch.storage_bytes(C) == C.nnz * 8 + (C.shape[0] + 1) * 4


def test_entry_matches_the_jax_entry():
    import __graft_entry__
    fn_j, args_j = __graft_entry__.entry()
    fn_t, (A, b) = graft_entry_torch.entry(device="cpu")
    assert A.device.type == "cpu" and b.dtype == torch.float32
    assert A.strategy == args_j[0].strategy == "banded"
    xj = np.asarray(fn_j(*args_j))
    xt = fn_t(A, b).numpy()
    assert xt.shape == xj.shape == (16 ** 3,)
    assert np.abs(xt - xj).max() / np.abs(xj).max() <= 1e-5


def test_entry_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        graft_entry_torch.entry()
