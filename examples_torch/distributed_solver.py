"""distributed-solver example: row-partitioned matrix over a mesh of
parts, Schwarz-preconditioned CG with the halo exchange.

The 4 parts share one device (the card, or the host with
``device="cpu"``): the JAX example's ``min(4, len(jax.devices()))`` parts
are 4 on its 8 virtual CPU devices.
"""

import os as _os, sys as _sys
_sys.path[:0] = [_d := _os.path.dirname(_os.path.abspath(__file__)),
                 _os.path.dirname(_d)]  # examples dir + repo root
from _example_setup import device_of

import numpy as np

from ginkgo_tpu_torch.distributed import (Partition, Schwarz,
                                          distribute_vector, make_mesh,
                                          read_distributed)
from ginkgo_tpu_torch.solver import Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import stencil_3d

PARTS = 4


def main(device=None):
    dev = device_of(device)
    P = PARTS
    mesh = make_mesh((P,), ("rows",), device=dev)
    data = stencil_3d(8, points=7)
    n = data.shape[0]
    part = Partition.build_from_global_size_uniform(P, n)
    A = read_distributed(data, part, mesh)
    b = distribute_vector(np.ones(n), part, mesh)
    M = Schwarz().generate(A)
    res = Cg.solve(A, b, preconditioner=M,
                   criteria=Iteration(500) | ResidualNorm(1e-10))
    print(f"{P}-part solve: iters={int(res.iterations[0])}, "
          f"converged={bool(res.converged.all())}")
    assert bool(res.converged.all())

    # -- beyond parity: the 2-D (rows x cols) block decomposition ----------
    # (distributed/matrix2d.py) — one sum over the mesh columns per apply,
    # halo-free; solvers run through it unchanged
    if P >= 4 and P % 2 == 0:
        from ginkgo_tpu_torch.distributed import (distribute_vector_2d,
                                                  read_distributed_2d)
        pr, pc = P // 2, 2
        mesh2 = make_mesh((pr, pc), ("rows", "cols"), device=dev)
        rp = Partition.build_from_global_size_uniform(pr, n)
        cp = Partition.build_from_global_size_uniform(pc, n)
        A2 = read_distributed_2d(data, rp, mesh2, col_partition=cp)
        b2 = distribute_vector_2d(np.ones(n), cp, mesh2, axis="cols")
        res2 = Cg.solve(A2, b2, criteria=Iteration(500) | ResidualNorm(1e-10))
        print(f"{pr}x{pc}-grid 2-D solve: iters={int(res2.iterations[0])}, "
              f"converged={bool(res2.converged.all())}")
        assert bool(res2.converged.all())
    return {"converged": bool(res.converged.all()),
            "iterations": int(res.iterations[0]),
            "residual": float(res.resnorm[0]),
            "residual_bound": 1e-6}


if __name__ == "__main__":
    main()
