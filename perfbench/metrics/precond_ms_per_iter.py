"""Device milliseconds launched inside the program's ``step.precond`` spans
(the preconditioner's apply) over the iterations (``program_trace.py``'s
device pass)."""

from perfbench import program_trace


def read(run):
    return program_trace.span_ms_per_iter(run, "step.precond")
