"""Entry point of the PyTorch/CUDA port, the counterpart of
``__graft_entry__.entry()``.

``entry(device="cuda")`` returns ``(fn, (A, b))``: the flagship step, one
CG solve on the 27-point Poisson system ``stencil_3d(16, points=27)`` in
f32 with ``Iteration(10) | ResidualNorm(1e-6)``; ``fn(A, b)`` returns x.
It runs on the CUDA card (and raises without one) unless the caller asks
for the host with ``device="cpu"``.
"""

import numpy as np
import torch


def entry(device="cuda"):
    from ginkgo_tpu_torch import Csr
    from ginkgo_tpu_torch.device import resolve_device
    from ginkgo_tpu_torch.solver import Cg
    from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
    from ginkgo_tpu_torch.utils.generators import stencil_3d

    device = resolve_device(None if device == "cuda" else device)
    data = stencil_3d(16, points=27)
    A = Csr.from_data(data, dtype=np.float32, device=device)
    b = torch.ones((A.shape[0],), dtype=torch.float32, device=device)
    crit = Iteration(10) | ResidualNorm(1e-6)

    def fn(A, b):
        return Cg.solve(A, b, criteria=crit).x

    return fn, (A, b)
