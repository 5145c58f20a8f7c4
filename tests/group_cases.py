"""What the ranks of ``tests/test_torch_rank_group.py`` run through a
``RankGroup``: port code alone (no JAX), each function called on every
rank as ``fn(*args, lead=...)``, rank 0 with ``lead``, the followers with
None.  A follower imports this module by name, so it imports nothing of
the tests' JAX side."""

import time

import torch
import torch.distributed as dist

from ginkgo_tpu_torch.distributed import make_mesh
from ginkgo_tpu_torch.distributed.matrix import DistributedMatrix
from ginkgo_tpu_torch.distributed.vector import (gather_rows, global_tensor,
                                                 scatter_rows)
from ginkgo_tpu_torch.preconditioner.jacobi import Jacobi
from ginkgo_tpu_torch.solver import Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm

# what ``build`` leaves on each rank for ``block_cg``
STATE = {}


def echo(value, lead=None):
    """Each rank's number, the sum of all ranks' (an all-reduce), and
    what the call handed this rank."""
    total = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(total)
    return dict(rank=dist.get_rank(), total=float(total), value=value,
                lead=lead)


def fail_on(rank, lead=None):
    """Raise on ``rank``; the others wait in a collective it never
    joins."""
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} failed on purpose")
    dist.barrier()


def hang(lead=None):
    """Rank 0 waits in a collective that the followers, asleep, never
    join."""
    if dist.get_rank() == 0:
        dist.barrier()
    while True:
        time.sleep(1)


def round_trip(partition, cols, lead=None):
    """Rank 0's block ``lead`` scattered over the ranks' rows and gathered
    back, and the padded vector as every rank holds it (an all-gather)."""
    mesh = make_mesh((partition.num_parts,), ("rows",))
    v = scatter_rows(lead, partition, mesh, cols=cols, dtype=torch.float64)
    return dict(padded=global_tensor(v), back=gather_rows(v, partition,
                                                          mesh))


def build(mine, static, partition, lead=None):
    """This rank's parts of the operator from its slice of the plan, and
    its scalar Jacobi."""
    mesh = make_mesh((partition.num_parts,), ("rows",))
    A = DistributedMatrix.from_arrays(mine, static, mesh)
    STATE.update(A=A, M=Jacobi().generate(A), mesh=mesh,
                 partition=partition)


def block_cg(cols, tol, max_iters, lead=None):
    """Jacobi-CG of rank 0's (n, cols) block: x gathered on rank 0, and
    each column's iterations."""
    s = STATE
    b = scatter_rows(lead, s["partition"], s["mesh"], cols=cols,
                     dtype=torch.float64)
    res = Cg.solve(s["A"], b, preconditioner=s["M"],
                   criteria=ResidualNorm(reduction_factor=tol)
                   | Iteration(max_iters=max_iters))
    return dict(x=gather_rows(res.x, s["partition"], s["mesh"]),
                iterations=res.iterations, converged=res.converged)
