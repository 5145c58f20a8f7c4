"""The program's ``allreduces`` counter (its all-reduces of dots and norms
over the ranks, on rank 0) over the ``loop.iteration`` spans of one solve
recorded after the window (``program_counters.py``)."""

from perfbench import program_counters


def read(run):
    return program_counters.per_iter(run, "allreduces")
