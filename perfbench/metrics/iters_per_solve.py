"""The mean over the window's solves of the program's reported
``SolveResult.iterations.max()`` (the slowest column of a block)."""


def read(run):
    return sum(s.iterations for s in run.solves) / len(run.solves)
