"""Launches of kernel A's wide instance (``dia_spmv_wide_cuda.launches``)
on rank 0 over its distributed SpMVs (``dist.exchange`` spans), in one
solve recorded after the window (``program_counters.py``): one part a rank
launches it once an SpMV.  On the card only (the host runs the plain
version)."""

from perfbench import program_counters


def read(run):
    return program_counters.per_spmv(run, program_counters.WIDE_LAUNCHES)
