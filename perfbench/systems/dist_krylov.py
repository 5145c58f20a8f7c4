"""The program's Jacobi-CG over ranks, one a card, through its public
distributed API and led by the benchmark's own process: HPCG's run over
``npx x npy x npz`` ranks as Ginkgo's distributed solver benchmark runs it,
one part a rank.

Set-up: ``DistributedMatrix.from_data`` plans the generated matrix over a
``Partition`` of ``parts`` contiguous row ranges once, on this process
(``mesh="schedule-only"``); a ``RankGroup`` of ``ranks`` ranks (this
process is rank 0, on card 0) ships each rank its slice of the plan
(``rank_arrays``), every rank builds its parts (``from_arrays``) and its
scalar Jacobi (``Jacobi().generate``).  ``solve(b)`` is one call of the
group: b scattered from card 0 over the ranks' rows, ``Cg.solve`` with
``ResidualNorm | Iteration`` on every rank, x gathered back to card 0.

The ranks run this file's ``build``, ``precondition`` and ``solve``,
which they import by the name ``RANKED``; a rank keeps its state in
``STATE`` between calls.
"""

from __future__ import annotations

import dataclasses
import importlib
import sys
import sysconfig
import time
from pathlib import Path

import numpy as np

RANKED = "perfbench.systems.dist_krylov"
STATE: dict = {}


def _unshadow():
    """Take every folder that holds a ``profile.py`` other than the
    standard library's off ``sys.path``, here and so in the ranks this
    process spawns: ``python3 perfbench/run.py`` puts the benchmark's own
    folder first, and its ``profile.py`` would shadow the standard
    library's, which torch's compiler imports when a DTensor is first
    made.  The benchmark imports its files as ``perfbench.*``."""
    stdlib = Path(sysconfig.get_paths()["stdlib"]).resolve()

    def shadows(folder):
        path = Path(folder or ".").resolve()
        return path != stdlib and (path / "profile.py").is_file()

    sys.path[:] = [p for p in sys.path if not shadows(p)]
    module = sys.modules.get("profile")
    if module is not None and shadows(Path(module.__file__).parent):
        del sys.modules["profile"]


class System:
    """Set-up once, then ``solve(b)`` per right-hand side block (n, k) on
    card 0; ``close()`` (also when dropped, and at exit) ends the ranks.

    ``spans`` (a dict) receives the seconds of each set-up phase:
    ``import`` (the program's), ``from_data`` (the plan, on this process),
    ``ranks`` (the group's start and every rank's operator from its
    slice) and ``precond``."""

    def __init__(self, matrix, config: dict, device, spans: dict):
        self.group = None
        _unshadow()
        t = time.perf_counter()
        # a program without the rank group fails here, before any rank
        # starts
        from ginkgo_tpu_torch.distributed.launch import RankGroup
        from ginkgo_tpu_torch import MatrixData
        from ginkgo_tpu_torch.distributed import Partition
        from ginkgo_tpu_torch.distributed.matrix import (DistributedMatrix,
                                                         rank_arrays)

        spans["import"] = time.perf_counter() - t
        if config["solver"] != "cg" or config["preconditioner"] != "jacobi":
            raise ValueError("dist_krylov runs Jacobi-CG alone, got "
                             f"{config['solver']!r} with "
                             f"{config['preconditioner']!r}")
        shape, rows, cols, values = matrix
        self.n, self.nnz = shape[0], len(values)
        world, parts = int(config["ranks"]), int(config["parts"])
        self.partition = Partition.build_from_global_size_uniform(parts,
                                                                  self.n)
        t = time.perf_counter()
        arrays, static = DistributedMatrix.from_data(
            MatrixData(shape, rows, cols, values), self.partition,
            mesh="schedule-only", comm=config["comm"],
            dtype=np.dtype(config["dtype"])).host_plan()
        spans["from_data"] = time.perf_counter() - t
        t = time.perf_counter()
        self.group = RankGroup(world, config["backend"])
        self.ranked = importlib.import_module(RANKED)
        self.group.call(self.ranked.build, static, self.partition,
                        config["tol"], config["max_iters"],
                        rank_args=rank_arrays(arrays, parts, world))
        del arrays
        spans["ranks"] = time.perf_counter() - t
        t = time.perf_counter()
        self.group.call(self.ranked.precondition)
        spans["precond"] = time.perf_counter() - t

    def solve(self, b):
        """The program's SolveResult: x (n, k) on card 0, iterations,
        converged and stagnated per column."""
        return self.group.call(self.ranked.solve, b.shape[1], b.dtype,
                               lead=b)

    def close(self):
        if self.group is not None:
            self.ranked.STATE.clear()
            self.group.close()
            self.group = None

    def __del__(self):
        self.close()


def build(mine, static, partition, tol, max_iters, lead=None):
    """A rank's parts of the operator from its slice of the plan, on its
    device, and the stopping criteria."""
    from ginkgo_tpu_torch.distributed import make_mesh
    from ginkgo_tpu_torch.distributed.matrix import DistributedMatrix
    from ginkgo_tpu_torch.stop.criterion import Iteration, ResidualNorm

    mesh = make_mesh((partition.num_parts,), ("rows",))
    STATE.update(A=DistributedMatrix.from_arrays(mine, static, mesh),
                 mesh=mesh, partition=partition,
                 criteria=(ResidualNorm(reduction_factor=tol)
                           | Iteration(max_iters=max_iters)))


def precondition(lead=None):
    from ginkgo_tpu_torch.preconditioner.jacobi import Jacobi

    STATE["M"] = Jacobi().generate(STATE["A"])


def solve(cols, dtype, lead=None):
    """One block: rank 0's ``lead`` (n, cols) scattered, solved, x
    gathered; rank 0's SolveResult with the natural x, None elsewhere."""
    from ginkgo_tpu_torch.distributed.vector import gather_rows, scatter_rows
    from ginkgo_tpu_torch.solver import Cg

    s = STATE
    b = scatter_rows(lead, s["partition"], s["mesh"], cols=cols, dtype=dtype)
    res = Cg.solve(s["A"], b, criteria=s["criteria"],
                   preconditioner=s["M"])
    x = gather_rows(res.x, s["partition"], s["mesh"])
    return None if x is None else dataclasses.replace(res, x=x)
