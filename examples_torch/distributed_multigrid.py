"""distributed-multigrid-preconditioned-solver example: AMG-preconditioned
CG on a row-partitioned operator (distributed fine level, whole coarse
grids), plus the two-level Schwarz variant.  The 4 parts share one device
(the card, or the host with ``device="cpu"``)."""

import os as _os, sys as _sys
_sys.path[:0] = [_d := _os.path.dirname(_os.path.abspath(__file__)),
                 _os.path.dirname(_d)]  # examples dir + repo root
from _example_setup import device_of

import numpy as np

from ginkgo_tpu_torch.distributed import (Partition, Schwarz,
                                          distribute_vector, make_mesh,
                                          read_distributed)
from ginkgo_tpu_torch.multigrid import DistributedPgm
from ginkgo_tpu_torch.solver import Cg, Multigrid
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import stencil_2d

PARTS = 4


def main(device=None):
    dev = device_of(device)
    P = PARTS
    mesh = make_mesh((P,), ("rows",), device=dev)
    data = stencil_2d(16, points=5)
    n = data.shape[0]
    part = Partition.build_from_global_size_uniform(P, n)
    A = read_distributed(data, part, mesh)
    b = distribute_vector(np.ones(n), part, mesh)
    crit = Iteration(300) | ResidualNorm(1e-10)

    mg = Multigrid.build(mg_level=DistributedPgm()).generate(A)
    amg = Cg.solve(A, b, criteria=crit, preconditioner=mg.cycle_operator())
    two_level = Cg.solve(
        A, b, criteria=crit,
        preconditioner=Schwarz(coarse_level=DistributedPgm()).generate(A))
    print(f"{P}-part AMG-CG: {int(amg.iterations[0])} iters; "
          f"two-level Schwarz-CG: {int(two_level.iterations[0])} iters")
    assert bool(amg.converged.all()) and bool(two_level.converged.all())
    return {"converged": bool(amg.converged.all())
            and bool(two_level.converged.all()),
            "amg_residual": float(amg.resnorm[0]),
            "amg_residual_bound": 1e-6,
            "iterations": int(amg.iterations[0])}


if __name__ == "__main__":
    main()
