"""Headline benchmark of the PyTorch/CUDA port: SpMV throughput on the
27-point Poisson stencil, the counterpart of ``bench.py``.

    python3 bench_torch.py                       # on the CUDA card, nx = 160
    python3 bench_torch.py --device cpu --nx 8   # the explicit host mode

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, the
schema of ``bench.py``.  Protocol as there: warm-up plus repeated chains,
storage-bytes accounting per Ginkgo's ``benchmark/utils/loggers.hpp:111``.

Timing: each measurement runs a chain of K1 and a chain of K2 steps and
takes the net time per step, (t(K2) - t(K1)) / (K2 - K1), which cancels
the fixed cost of a chain; on the card each chain is timed with CUDA
events, on the host with the wall clock.  The result is the median of an
odd number of such samples.  The STREAM bound is measured in situ the same
way, and ``vs_baseline`` = achieved GB/s / (0.8 * STREAM), so >= 1.0 meets
the per-device target.  Without a CUDA device, and no ``--device cpu``,
the script exits with status 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

SAMPLES = 5


def median_of_odd(values):
    """The median of an odd number of samples: the middle one, never the
    mean of two (``statistics.median`` averages them for an even count)."""
    if len(values) % 2 != 1:
        raise ValueError(f"need an odd number of samples, got {len(values)}")
    return statistics.median(values)


def _chain_seconds(step, z0, K, device):
    """Seconds of K chained steps from ``z0``, after one warm-up step."""
    step(z0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        z = z0
        for _ in range(K):
            z = step(z)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    z = z0
    for _ in range(K):
        z = step(z)
    return time.perf_counter() - t0


def net_step_seconds(step, z0, k1, k2, device, samples=SAMPLES):
    """Median over ``samples`` (odd) of the net time of one step."""
    ts = []
    for _ in range(samples):
        t1 = _chain_seconds(step, z0, k1, device)
        t2 = _chain_seconds(step, z0, k2, device)
        ts.append(max((t2 - t1) / (k2 - k1), 1e-12))
    return median_of_odd(ts)


def measure_stream_gbps(device):
    """In-situ STREAM triad, z <- a s + z t with s + t = 1 (one
    ``torch.lerp`` pass: reads a and z, writes z, 3 n accesses), over 64 Mi
    f32 on the card and 4 Mi on the host."""
    n = (64 if device.type == "cuda" else 4) * 1024 * 1024
    a = torch.ones(n, dtype=torch.float32, device=device)
    z0 = torch.full((n,), 0.5, dtype=torch.float32, device=device)

    def step(z):
        return torch.lerp(z, a, 1e-7, out=z)

    t = net_step_seconds(step, z0.clone(), 8, 40, device)
    return 3 * n * 4 / t / 1e9


def storage_bytes(A):
    """The f32 operator's storage as ``bench.py`` counts it: the banded
    values (no index storage) plus the COO tail, else values, column
    indices and row pointers."""
    n, vbytes = A.shape[0], 4
    if A.strategy == "banded":
        storage = A.diag_values.numel() * vbytes
        if A.tail_vals is not None:
            storage += A.tail_vals.numel() * (vbytes + 8)
        return storage
    return A.nnz * (vbytes + 4) + (n + 1) * 4


def measure_spmv(device, nx):
    """Kernel A's SpMV on ``stencil_3d(nx, points=27)`` in f32, k = 1,
    through ``Csr._apply``, scaled by 1/27 a step.  Returns (A, n, GB/s)."""
    from ginkgo_tpu_torch import Csr
    from ginkgo_tpu_torch.utils.generators import stencil_3d

    A = Csr.from_data(stencil_3d(nx, points=27), dtype=np.float32,
                      device=device)
    n = A.shape[0]
    x = torch.ones((n, 1), dtype=torch.float32, device=device)
    scale = 1.0 / 27.0

    def step(z):
        return A._apply(z) * scale

    k1, k2 = (8, 64) if device.type == "cuda" else (2, 8)
    t = net_step_seconds(step, x, k1, k2, device)
    bytes_moved = storage_bytes(A) + 2 * n * 4
    return A, n, bytes_moved / t / 1e9


def result_line(A, n, gbps, stream, backend):
    """The JSON object ``bench.py`` prints, for this backend."""
    return {"metric": f"spmv_27pt_poisson_n{n}_{A.strategy}_{backend}"
                      f"_stream{stream:.0f}",
            "value": round(gbps, 2),
            "unit": "GB/s",
            "vs_baseline": round(gbps / (0.8 * stream), 4)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--nx", type=int, default=None,
                        help="stencil size (default 160 on the card, 48 on "
                             "the host)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device; pass --device cpu to run on the "
              "host", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    nx = args.nx or (160 if device.type == "cuda" else 48)
    stream = measure_stream_gbps(device)
    A, n, gbps = measure_spmv(device, nx)
    print(json.dumps(result_line(A, n, gbps, stream, device.type)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
