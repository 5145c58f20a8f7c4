"""Device milliseconds launched inside the program's ``dist.exchange``
spans (the halo exchange's pack, ``all_to_all_single`` and unpack) over
the iterations, on rank 0's card (``program_trace.py``'s device pass,
which traces the process that leads the ranks; the collective's own
range counted in, ``dist_spans.py``)."""

from perfbench import dist_spans


def read(run):
    return dist_spans.ms_per_iter(run, "dist.exchange")
