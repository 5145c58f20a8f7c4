"""Distributed SpMV weak-scaling benchmark
(``ginkgo_tpu/benchmark/distributed.py`` in torch).

Analog of ``benchmark/spmv/distributed`` + ``benchmark/solver/distributed``:
runs the distributed SpMV over 1..P parts with the problem size scaled
proportionally (weak scaling) and reports per-configuration nnz/s plus
efficiency against the 1-part baseline, with the reference's JSON keys.

The JAX package falls back to the CPU backend's virtual devices when the
default platform has fewer than P devices.  The port does not fall back:
every part of a configuration runs on the one ``-device`` (the CUDA device
by default), and each entry's ``device_pool`` says so.  Parts co-resident
on one card share its memory bandwidth, so the efficiency measured there
is the cost of the exchange and of P launches an apply, not scaling.
"""

from __future__ import annotations

import numpy as np

from .runner import (base_parser, chain_k_for_backend, emit, parse_device,
                     time_chained)


def run_weak_scaling(base_edge: int, parts_list, comm, args):
    from ..distributed import (Partition, distribute_vector, make_mesh,
                               read_distributed)
    from ..utils.generators import stencil_3d
    dev = args.device
    k1, k2 = chain_k_for_backend(dev.type)
    results = []
    base_nnz_per_s = None
    for P in parts_list:
        # weak scaling: rows grow with P (z-extent scales)
        data = stencil_3d(base_edge, base_edge, base_edge * P, points=27)
        n = data.shape[0]
        nnz = data.canonical().nnz
        part = Partition.build_from_global_size_uniform(P, n)
        mesh = make_mesh((P,), ("rows",), device=dev)
        A = read_distributed(data, part, mesh, comm=comm, dtype=np.float32)
        x = distribute_vector(np.ones((n, 1), np.float32), part, mesh)
        nrm = float(A._apply(x).abs().max())
        scale = 1.0 / max(nrm, 1.0)

        def mk(K):
            def chain(A, z):
                for _ in range(K):
                    z = A._apply(z) * scale
                return z.sum()
            return chain

        t = time_chained(mk, (A, x), k1, k2,
                         reps=max(args.repetitions // 2, 2))
        nnz_per_s = nnz / t
        entry = {"devices": P, "rows": n, "nonzeros": nnz,
                 "time": t, "nnz_per_s": nnz_per_s, "comm": comm,
                 "device_pool": f"{dev} (all {P} parts on one device)"}
        if P == 1:
            base_nnz_per_s = nnz_per_s      # the documented 1-part base
        if base_nnz_per_s is not None:
            entry["weak_scaling_efficiency"] = (
                nnz_per_s / (P * base_nnz_per_s))
        results.append(entry)
    return results


def main(argv=None):
    p = base_parser("ginkgo_tpu_torch distributed weak-scaling benchmark")
    p.add_argument("-base_edge", type=int, default=24)
    p.add_argument("-devices", type=str, default="1,2,4,8",
                   help="part counts (all on -device)")
    p.add_argument("-comm", type=str, default="dense")
    args = parse_device(p, argv)
    parts = [int(s) for s in args.devices.split(",")]
    results = run_weak_scaling(args.base_edge, parts, args.comm, args)
    emit(results, args)
    return results


if __name__ == "__main__":
    main()
