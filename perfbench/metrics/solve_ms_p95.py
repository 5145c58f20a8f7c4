"""The 95th percentile of the window's solve times (start to the device's
synchronisation), nearest rank over all solves of the window."""

import math


def read(run):
    times = sorted(s.end - s.start for s in run.solves)
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]
