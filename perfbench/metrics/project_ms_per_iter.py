"""Device milliseconds launched inside the program's ``gmres.project``
spans (both CGS2 passes over the Krylov basis) over the iterations
(``program_trace.py``'s device pass)."""

from perfbench import program_trace


def read(run):
    return program_trace.span_ms_per_iter(run, "gmres.project")
