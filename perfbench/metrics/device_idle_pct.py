"""The share of the traced window in which the device ran nothing:
100 (1 - busy / window), from the profiler's trace of a few steady solves
after the measured window."""


def read(run):
    trace = run.trace
    if not trace or trace.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
