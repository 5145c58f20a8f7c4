"""Device time of the program's distributed spans with their collectives:
what ``exchange_ms_per_iter.4card`` and ``allreduce_ms_per_iter.4card``
read.

``program_trace.py``'s device pass gives each device event to the
innermost span open when it was launched.  A collective opens a profiler
range of its own inside the program's span (``nccl:all_to_all``,
``nccl:all_reduce``; ``gloo:...`` on the host), and NCCL's kernel is
launched inside it, so on a card a span's time is its own events' plus
those of the collectives it runs.  On the host, where a span's device time
is its own duration, the collective's range is already inside it.
"""

from __future__ import annotations

from . import program_trace

# the collectives each span runs, by the operation in their range's name
COLLECTIVES = {"dist.exchange": ("all_to_all",),
               "dist.allreduce": ("all_reduce", "allreduce")}


def ms_per_iter(run, span: str):
    """Device milliseconds of ``span`` and its collectives over the device
    pass's iterations, or None where the pass had no such span."""
    s = program_trace.summary(run)
    if s is None or span not in s["device"]["device_s"]:
        return None
    dev = s["device"]
    seconds = dev["device_s"][span]
    if run.device.type == "cuda":
        seconds += sum(t for name, t in dev["device_s"].items()
                       if ":" in name and name.split(":", 1)[1].startswith(
                           COLLECTIVES[span]))
    return 1e3 * seconds / dev["iterations"]
