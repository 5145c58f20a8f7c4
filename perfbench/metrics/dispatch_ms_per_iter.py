"""The mean milliseconds of the program's ``loop.iteration`` spans less
their ``loop.host_read`` children: the host's own time in an iteration
(Python, dispatch, launches), on the host's clock (``program_trace.py``'s
host pass)."""

from perfbench import program_trace


def read(run):
    return program_trace.per_iter(run, "host", "dispatch_ms_per_iter")
