"""The program's ``exchange_bytes`` counter (the bytes rank 0 sends to
other ranks in its halo exchanges) over the ``loop.iteration`` spans of
one solve recorded after the window (``program_counters.py``): an SpMV
an iteration, plus the start's and the audit's."""

from perfbench import program_counters


def read(run):
    return program_counters.per_iter(run, "exchange_bytes")
