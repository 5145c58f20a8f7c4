#!/usr/bin/env python3
"""Probe where f32 arithmetic stalls the port's complex64 Krylov solves.

    python3 tools/torch_complex_probe.py [--device cuda|cpu] [--nx 160]
                                         [--system shifted|hermitian]
                                         [--solvers Bicg,Bicgstab] [--jax]

On a complex system of ``chip_smoke.py`` with P the 27-point stencil at
``--nx`` (``shifted``: A = P (1 + 0.02i) + 0.5i I; ``hermitian``: H = P +
1.02 I + 0.02i (U - U^T), U the strict upper triangle of P), with b = ones
(on the banded layout), each named solver

1. runs ``ITERS`` iterations with ``trace=True`` and a tolerance no solve
   reaches, in complex64 and then complex128: the recurrent relative
   residual at checkpoints, its least value and the iteration of it, and
   the true relative residual of the final x recomputed in complex128;
2. solves in complex64 to each ``ResidualNorm`` tolerance of ``TOLS``
   (2000 iterations at most): iterations, converged, stagnated and the
   true relative residual, which shows the tightest tolerance a complex64
   solve meets.

With ``--jax`` (host only; needs the JAX package) the JAX package's solver
runs the traced solves of 1 on the same system beside the port's, to show
whether a stall is the arithmetic's or the port's.

Prints the card's ``nvidia-smi`` name and power limit on the card, then
one JSON object per line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import ginkgo_tpu_torch as gtt  # noqa: E402
import ginkgo_tpu_torch.solver as tsolver  # noqa: E402
from ginkgo_tpu_torch.ops.spmv import coo_spmv  # noqa: E402
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm  # noqa: E402
from ginkgo_tpu_torch.utils.generators import stencil_3d  # noqa: E402

ITERS = 600
CHECKPOINTS = (0, 10, 20, 40, 80, 160, 320, ITERS)
TOLS = (1e-1, 5e-2, 2e-2, 1e-2, 1e-3, 1e-4, 3e-5, 1e-5)


def system(kind, nx):
    d = stencil_3d(nx, points=27)
    r, c = d.row_idx, d.col_idx
    if kind == "shifted":
        vals = d.values * (1 + 0.02j) + 0.5j * (r == c)
    else:
        vals = (d.values + 1.02 * (r == c)
                + 0.02j * np.sign(c.astype(np.int64) - r) * d.values)
    return gtt.MatrixData(d.shape, r, c, vals)


def true_residual(A, x, b):
    wide = torch.complex128
    r = b.to(wide) - coo_spmv(A.row_idx, A.col_idx, A.values.to(wide),
                              x.to(wide)[:, None], A.shape[0])[:, 0]
    return float(r.norm() / b.to(wide).norm())


def summary(history, b_norm):
    h = np.asarray(history, np.float64) / b_norm
    return dict(at={c: float(h[min(c, len(h) - 1)]) for c in CHECKPOINTS},
                least=float(h.min()), least_at=int(h.argmin()))


def run_port(data, dtype, solver, device):
    A = gtt.Csr.from_data(data, dtype=dtype, device=device)
    b = torch.ones(A.shape[0], dtype=A.dtype, device=device)
    res = getattr(tsolver, solver).solve(
        A, b, criteria=Iteration(ITERS) | ResidualNorm(1e-30), trace=True)
    history = res.resnorm_history[:, 0].cpu()
    return dict(summary(history, float(b.abs().norm())),
                true_rel_residual=true_residual(A, res.x, b))


def sweep(data, solver, device):
    A = gtt.Csr.from_data(data, dtype=np.complex64, device=device)
    b = torch.ones(A.shape[0], dtype=A.dtype, device=device)
    out = []
    for tol in TOLS:
        res = getattr(tsolver, solver).solve(
            A, b, criteria=Iteration(2000) | ResidualNorm(tol))
        out.append(dict(tol=tol, iterations=int(res.iterations[0]),
                        converged=bool(res.converged[0]),
                        stagnated=None if res.stagnated is None
                        else bool(res.stagnated[0]),
                        true_rel_residual=true_residual(A, res.x, b)))
    return out


def run_jax(data, dtype, solver):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import ginkgo_tpu as gt
    import ginkgo_tpu.solver as jsolver
    from ginkgo_tpu.stop.criterion import Iteration as JIteration
    from ginkgo_tpu.stop.criterion import ResidualNorm as JResidualNorm
    A = gt.Csr.from_data(gt.MatrixData(data.shape, data.row_idx,
                                       data.col_idx, data.values),
                         dtype=dtype)
    b = jnp.ones(A.shape[0], dtype)
    res = getattr(jsolver, solver).solve(
        A, b, criteria=JIteration(ITERS) | JResidualNorm(1e-30), trace=True)
    x = np.asarray(res.x).astype(np.complex128)
    dense_r = np.ones(A.shape[0], np.complex128)
    np.subtract.at(dense_r, data.row_idx,
                   data.values.astype(dtype).astype(np.complex128)
                   * x[data.col_idx])
    return dict(summary(np.asarray(res.resnorm_history)[:, 0],
                        float(np.sqrt(A.shape[0]))),
                true_rel_residual=float(np.linalg.norm(dense_r)
                                        / np.sqrt(A.shape[0])))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--nx", type=int, default=160)
    parser.add_argument("--system", default="shifted",
                        choices=("shifted", "hermitian"))
    parser.add_argument("--solvers", default="Bicg,Bicgstab")
    parser.add_argument("--jax", action="store_true")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device; pass --device cpu", file=sys.stderr)
            return 2
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
    data = system(args.system, args.nx)
    for solver in args.solvers.split(","):
        for dtype in (np.complex64, np.complex128):
            out = dict(solver=solver, system=args.system, nx=args.nx,
                       dtype=np.dtype(dtype).name, iterations=ITERS,
                       port=run_port(data, dtype, solver, device))
            if args.jax:
                out["jax"] = run_jax(data, dtype, solver)
            print(json.dumps(out), flush=True)
        print(json.dumps(dict(solver=solver, system=args.system, nx=args.nx,
                              dtype="complex64",
                              sweep=sweep(data, solver, device))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
