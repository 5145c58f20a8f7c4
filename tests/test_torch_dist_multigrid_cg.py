"""AMG-preconditioned CG on a distributed operator
(``multigrid/distributed_pgm.py`` under ``solver/multigrid.py``): the
port's iterations equal to ginkgo_tpu's on the same numpy inputs, on the
CPU, in f64, x to 1e-8, and no more than plain CG's.  Alone in its file:
the reference's solve takes about a minute to compile."""

import numpy as np

from ginkgo_tpu.multigrid.distributed_pgm import DistributedPgm as JDistPgm
import ginkgo_tpu.solver as jsolver
from ginkgo_tpu.stop.criterion import Iteration as JIteration
from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
from ginkgo_tpu_torch.multigrid import DistributedPgm
from ginkgo_tpu_torch.solver import Cg, Multigrid
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import stencil_2d
from test_torch_dist_multigrid import X_TOL, systems


def test_distributed_multigrid_preconditioned_cg():
    data = stencil_2d(16, points=5)
    Aj, bj, At, bt, part = systems(data)
    mgj = jsolver.Multigrid.build(mg_level=JDistPgm()).generate(Aj)
    mgt = Multigrid.build(mg_level=DistributedPgm()).generate(At)
    rj = jsolver.Cg.solve(Aj, bj, criteria=JIteration(300)
                          | JResidualNorm(1e-10),
                          preconditioner=mgj.cycle_operator())
    rt = Cg.solve(At, bt, criteria=Iteration(300) | ResidualNorm(1e-10),
                  preconditioner=mgt.cycle_operator())
    plain = Cg.solve(At, bt, criteria=Iteration(300) | ResidualNorm(1e-10))
    assert bool(rt.converged.all())
    assert int(rt.iterations[0]) == int(rj.iterations[0])
    assert int(rt.iterations[0]) <= int(plain.iterations[0])
    xj, xt = np.asarray(rj.x), rt.x.numpy()
    assert np.abs(xt - xj).max() <= X_TOL * np.abs(xj).max()
