"""Top-level host ops (``cpu_op`` events inside no other) that start in
the program's ``loop.iteration`` spans, over their number: what the host
dispatches in an iteration (``program_trace.py``'s device pass)."""

from perfbench import program_trace


def read(run):
    return program_trace.per_iter(run, "device", "ops_per_iter")
