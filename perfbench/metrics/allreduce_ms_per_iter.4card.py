"""Device milliseconds launched inside the program's ``dist.allreduce``
spans (the all-reduce of every dot and norm over the ranks) over the
iterations, on rank 0's card (``program_trace.py``'s device pass; the
collective's own range counted in, ``dist_spans.py``).  NCCL's kernels
spin while they wait for the slowest rank, so this includes the wait for
the other ranks, not the reduction's work alone."""

from perfbench import dist_spans


def read(run):
    return dist_spans.ms_per_iter(run, "dist.allreduce")
