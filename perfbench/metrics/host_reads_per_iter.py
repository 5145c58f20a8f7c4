"""The program's ``host_reads`` counter over its ``loop.iteration`` spans:
device-to-host reads an iteration, the audit's and the solution update's
included (``program_trace.py``'s host pass)."""

from perfbench import program_trace


def read(run):
    return program_trace.per_iter(run, "host", "host_reads_per_iter")
