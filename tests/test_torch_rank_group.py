"""Ranks led by the calling process (``distributed/launch.py::RankGroup``)
and the ranked block solve it drives, on 2 gloo ranks on the CPU.

One group serves the module (the test process is rank 0, one follower
spawned once); a test that breaks it on purpose leaves the next test a
fresh one.  The rank bodies are in ``group_cases.py``, which imports no
JAX:

* calls run in lock-step and return rank 0's result; only rank 0 gets
  ``lead``;
* a follower that raises fails the call with its traceback, a hang
  raises ``TimeoutError``, and either leaves no follower running;
  ``close()`` leaves none; a follower exits when its leader is killed;
* ``scatter_rows``/``gather_rows`` move a block from rank 0's device to
  the ranks' rows and back bit for bit;
* Jacobi-CG on HPCG's matrix (``perfbench/matrices/hpcg27.py``, 16^3, f64,
  one part a rank, 16 seeded columns), planned once here and shipped
  rank by rank, takes the plain reference's (``perfbench/reference/
  krylov.py``) iterations in every column, x within 1e-10 of its x.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import group_cases
from ginkgo_tpu_torch.base.matrix_data import MatrixData
from ginkgo_tpu_torch.distributed import Partition
from ginkgo_tpu_torch.distributed.launch import RankGroup
from ginkgo_tpu_torch.distributed.matrix import (DistributedMatrix,
                                                 rank_arrays)
from perfbench.matrices import hpcg27
from perfbench.reference import krylov

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
TIMEOUT = 120
# f64 rounding over about 30 iterations, with the reductions summed in
# another order over the ranks, stays near 1e-13; an f32 solve misses by
# about 1e-6
X_TOL = 1e-10

_live = []


@pytest.fixture
def group():
    """The module's group of 2 gloo ranks, made again if a test broke
    it."""
    if not _live or _live[0].closed:
        _live[:] = [RankGroup(WORLD, "gloo", timeout=TIMEOUT)]
    yield _live[0]


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_close_at_end():
    """Every rank on one torch thread (the followers read
    ``OMP_NUM_THREADS`` when they start): under the suite's workers more
    threads oversubscribe the cores and a solve of a second takes a
    minute."""
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)
        for g in _live:
            g.close()


LEADER = """
import time
from ginkgo_tpu_torch.distributed.launch import RankGroup
group = RankGroup(2, "gloo")
print(*group.pids, flush=True)
time.sleep(600)
"""


@pytest.fixture(scope="module", autouse=True)
def leader():
    """A leader of its own group, in a process of its own, started with
    the module so that its start overlaps the other tests."""
    proc = subprocess.Popen([sys.executable, "-c", LEADER], cwd=ROOT,
                            stdout=subprocess.PIPE, text=True,
                            env={**os.environ, "OMP_NUM_THREADS": "1"})
    yield proc
    proc.kill()
    proc.wait()


def alive(pid: int) -> bool:
    """The process ``pid`` runs (a zombie, which no longer runs, is
    not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def gone(pids, seconds: float) -> bool:
    deadline = time.monotonic() + seconds
    while any(alive(p) for p in pids):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.1)
    return True


def test_calls_run_in_lock_step_and_return_rank0s_result(group):
    for value in range(3):
        out = group.call(group_cases.echo, value, lead="mine")
        # the all-reduce met rank 1 (1 + 2): both ranks ran the call
        assert out == dict(rank=0, total=3.0, value=value, lead="mine")


def test_rows_round_trip_bit_for_bit(group):
    """A block of 11 rows over 2 parts of 6 (one padded row): scattered
    from rank 0, every rank holds its part's rows; gathered back, rank 0
    gets the block bit for bit."""
    part = Partition.build_from_global_size_uniform(WORLD, 11)
    x = torch.randn((11, 3), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    out = group.call(group_cases.round_trip, part, 3, lead=x)
    assert torch.equal(out["back"], x)
    assert torch.equal(out["padded"],
                       torch.from_numpy(part.to_padded(x.numpy())))


def test_ranked_block_cg_takes_the_references_iterations(group):
    data = MatrixData(*hpcg27.generate({"nx": 16, "ny": 16, "nz": 16,
                                        "dtype": "float64"}))
    n = data.shape[0]
    part = Partition.build_from_global_size_uniform(WORLD, n)
    arrays, static = DistributedMatrix.from_data(
        data, part, mesh="schedule-only").host_plan()
    group.call(group_cases.build, static, part,
               rank_args=rank_arrays(arrays, WORLD, WORLD))
    b = torch.randn((n, 16), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    tol, cap = 1e-8, 500
    got = group.call(group_cases.block_cg, 16, tol, cap, lead=b)
    op = krylov.operator((data.shape, data.row_idx, data.col_idx,
                          data.values), "cpu")
    ref = krylov.cg(op, b, tol=tol, max_iters=cap)
    assert bool(got["converged"].all()) and bool(ref.converged.all())
    assert got["iterations"].tolist() == ref.iterations.tolist()
    gap = (torch.linalg.vector_norm(got["x"] - ref.x, dim=0)
           / torch.linalg.vector_norm(ref.x, dim=0))
    assert float(gap.max()) <= X_TOL


def test_rank_args_need_one_entry_a_rank(group):
    with pytest.raises(ValueError, match="1 entries for 2 ranks"):
        group.call(group_cases.echo, 0, rank_args=[None])
    assert np.isfinite(group.call(group_cases.echo, 0)["total"])


def test_close_leaves_no_process(group):
    pids = group.pids
    group.close()
    assert group.closed and not any(alive(p) for p in pids)
    with pytest.raises(RuntimeError, match="closed"):
        group.call(group_cases.echo, 0)
    group.close()       # a second close does nothing


def test_a_failing_follower_fails_the_call(group):
    """Rank 1 raises while rank 0 waits in a collective: the call raises
    rank 1's traceback at once, and no follower is left."""
    pids = group.pids
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*"
                       "group_cases.py.*failed on purpose"):
        group.call(group_cases.fail_on, 1)
    assert time.monotonic() - t < 30
    assert group.closed and not any(alive(p) for p in pids)


def test_a_hang_raises_timeout_error():
    g = RankGroup(WORLD, "gloo", timeout=1)
    pids = g.pids
    t = time.monotonic()
    with pytest.raises(TimeoutError, match="within 1.0 s"):
        g.call(group_cases.hang)
    assert time.monotonic() - t < 30
    assert g.closed and not any(alive(p) for p in pids)


def test_followers_exit_when_their_leader_is_killed(leader):
    pids = [int(p) for p in leader.stdout.readline().split()]
    assert pids and all(alive(p) for p in pids)
    leader.send_signal(signal.SIGKILL)
    leader.wait()
    assert gone(pids, 10)


def test_nccl_group_needs_a_card_a_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="one card each"):
        RankGroup(WORLD, "nccl")
