"""The window's milliseconds over all its iterations (each solve counted
by its slowest column): the solver loop's time an iteration."""


def read(run):
    iterations = sum(s.iterations for s in run.solves)
    return 1e3 * run.window_s / iterations if iterations else None
