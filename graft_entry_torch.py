"""Entry points of the PyTorch/CUDA port, the counterparts of
``__graft_entry__.entry()`` and ``dryrun_multichip``.

``entry(device="cuda")`` returns ``(fn, (A, b))``: the flagship step, one
CG solve on the 27-point Poisson system ``stencil_3d(16, points=27)`` in
f32 with ``Iteration(10) | ResidualNorm(1e-6)``; ``fn(A, b)`` returns x.

``dryrun_multichip(n_devices)`` builds the distributed tier over a mesh of
``n_devices`` parts (Partition + IndexMap + DistributedMatrix with its
halo exchange) and runs the reference's checks against numpy oracles.

Both run on the CUDA card (and raise without one) unless the caller asks
for the host with ``device="cpu"``; the parts of the mesh share that one
device, with no fallback to another.
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


def _check(x, oracle, label):
    err = np.abs(x - oracle).max()
    if not err < 1e-2 * np.abs(oracle).max():
        raise AssertionError(f"{label} disagrees with the serial oracle: "
                             f"max err {err}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Schwarz-preconditioned CG, neighborhood-communicator CG, the 2-D
    block CG (for a power-of-two ``n_devices`` >= 4) and a packed-local
    BiCGSTAB over a mesh of ``n_devices`` parts, each checked against the
    numpy oracle (f64 values)."""
    from ginkgo_tpu_torch.base.matrix_data import MatrixData
    from ginkgo_tpu_torch.distributed import (Partition, Schwarz,
                                              distribute_vector,
                                              distribute_vector_2d,
                                              make_mesh, read_distributed,
                                              read_distributed_2d)
    from ginkgo_tpu_torch.solver import Bicgstab, Cg
    from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
    from ginkgo_tpu_torch.utils.generators import stencil_3d

    mesh = make_mesh((n_devices,), ("rows",), device=device)
    # tiny 27-pt Poisson over the full distributed stack, solved to 1e-6
    # and CHECKED against the serial numpy oracle (not just isfinite)
    data = stencil_3d(8, points=27)
    n = data.shape[0]
    x_oracle = np.linalg.solve(data.to_dense(), np.ones(n))
    part = Partition.build_from_global_size_uniform(n_devices, n)
    A = read_distributed(data, part, mesh)
    b = distribute_vector(np.ones(n), part, mesh)
    crit = Iteration(400) | ResidualNorm(1e-6)
    x = Cg.solve(A, b, criteria=crit,
                 preconditioner=Schwarz().generate(A)).x
    _check(part.from_padded(x.cpu().numpy()), x_oracle,
           "distributed Schwarz-CG")

    # neighborhood (ring-shift) communicator: same solve, same oracle
    An = read_distributed(data, part, mesh, comm="neighborhood")
    xn = Cg.solve(An, b, criteria=crit).x
    _check(part.from_padded(xn.cpu().numpy()), x_oracle,
           "neighborhood-comm CG")

    # 2-D (rows x cols) block decomposition; power-of-two counts only:
    # pr = n_devices//2 and pc = 2 must give matching padded sizes
    if n_devices >= 4 and (n_devices & (n_devices - 1)) == 0:
        pr, pc = n_devices // 2, 2
        mesh2 = make_mesh((pr, pc), ("rows", "cols"), device=mesh.device)
        rp = Partition.build_from_global_size_uniform(pr, n)
        cp = Partition.build_from_global_size_uniform(pc, n)
        A2 = read_distributed_2d(data, rp, mesh2, col_partition=cp)
        b2 = distribute_vector_2d(np.ones(n), cp, mesh2, axis="cols")
        x2 = Cg.solve(A2, b2, criteria=crit).x
        _check(rp.from_padded(x2.cpu().numpy()), x_oracle, "2-D block CG")

    # unstructured local blocks: a scattered FEM-like matrix must take the
    # packed layout per part (needs local blocks >= 256 rows, so its own
    # size) and still match the serial oracle
    nu = 4096
    rng = np.random.default_rng(3)
    n_off = 10
    offs = rng.integers(-300, 300, (nu // 128, n_off))
    pick = rng.random((nu, n_off)) < 0.6
    r2 = np.repeat(np.arange(nu), n_off).reshape(nu, n_off)
    c2 = np.clip(r2 + offs[np.arange(nu) // 128], 0, nu - 1)
    r, c = r2[pick], c2[pick]
    key = np.unique(r * nu + c)
    du = MatrixData(
        (nu, nu),
        np.concatenate([key // nu, np.arange(nu)]),
        np.concatenate([key % nu, np.arange(nu)]),
        np.concatenate([0.1 * rng.standard_normal(key.size),
                        np.full(nu, 4.0)])).canonical()
    xu_oracle = np.linalg.solve(du.to_dense(), np.ones(nu))
    part_u = Partition.build_from_global_size_uniform(n_devices, nu)
    Au = read_distributed(du, part_u, mesh)
    if Au.pell_vals is None:
        raise AssertionError("unstructured local blocks must take the "
                             "packed layout")
    bu = distribute_vector(np.ones(nu), part_u, mesh)
    xu = Bicgstab.solve(Au, bu, criteria=crit).x
    _check(part_u.from_padded(xu.cpu().numpy()), xu_oracle,
           "packed-local-block BiCGSTAB")
