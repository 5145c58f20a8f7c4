"""The operator's apply against its memory roofline, in %.

After the window, CUDA events time ``A.apply`` on the cell's own k columns
over chains of warm launches queued behind a spinning kernel (so the host's
launch cost stays out), the median of the chains.  The bound counts each
stored value of the matrix once and x and y once (``bytes_moved``), over
the card's HBM bandwidth in ``peaks.json``.  It times the operator at its
boundary, so it reads the same work whatever kernel implements it."""

import statistics

import torch

CHAINS = 5
LAUNCHES = 20
SPIN_CYCLES = 50_000_000     # about 25 ms at the H100's 1.98 GHz


def bytes_moved(nnz: int, n: int, k: int, value_bytes: int) -> int:
    """Each nonzero's value once, x (n, k) read once, y (n, k) written
    once."""
    return (nnz + 2 * n * k) * value_bytes


def apply_seconds(apply, x) -> float:
    """Median seconds of one apply over CHAINS chains of LAUNCHES."""
    for _ in range(3):
        apply(x)
    times = []
    for _ in range(CHAINS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(LAUNCHES):
            apply(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / LAUNCHES)
    return statistics.median(times)


def read(run):
    system = run.system
    if run.device.type != "cuda" or not run.peaks or system is None:
        return None
    k = int(run.cell.traffic["columns"])
    x = torch.randn((system.n, k), device=run.device,
                    dtype=getattr(torch, run.cell.config["dtype"]))
    t = apply_seconds(system.apply, x)
    bound = bytes_moved(system.nnz, system.n, k, system.value_bytes) / \
        run.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / t
