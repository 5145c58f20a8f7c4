"""The program's counters over one solve recorded after the window: what
the readers of counts an iteration or an SpMV read
(``exchange_bytes_per_iter.4card``, ``allreduces_per_iter.4card``,
``dia_wide_launches_per_spmv.4card``).

One solve of a right-hand side drawn from this file's own seed runs under
the program's recording (``ginkgo_tpu_torch.log.record``) alone, with no
profiler; a counter's total over the solve is divided by its
``loop.iteration`` spans, or by its ``dist.exchange`` spans (one a
distributed SpMV).  On a card the recording also holds kernel A's wide
launches over the solve (``WIDE_LAUNCHES``, the wrapper's own tally).  In
a cell whose system leads ranks, the recording is rank 0's: the counts of
the process that runs the window.  The summary is kept on the run, so the
readers share one solve.  A program without the recording, or without
the counter or span, gives None, and the readers leave their metrics out.
"""

from __future__ import annotations

import torch

from .rhs import RhsStream

SEED = 1_900_000_021     # a right-hand side apart from the window's
ITERATION = "loop.iteration"
EXCHANGE = "dist.exchange"
WIDE_LAUNCHES = "dia_spmv_wide_cuda.launches"
_KEY = "_program_counters"


def per_iter(run, counter: str):
    """``counter``'s total over the recorded solve's iterations, or
    None."""
    return _per(run, counter, "iterations")


def per_spmv(run, counter: str):
    """``counter``'s total over the recorded solve's distributed SpMVs, or
    None."""
    return _per(run, counter, "spmvs")


def _per(run, counter: str, unit: str):
    if not hasattr(run, _KEY):
        setattr(run, _KEY, _record(run))
    s = getattr(run, _KEY)
    if s is None or not s[unit] or counter not in s["counters"]:
        return None
    return s["counters"][counter] / s[unit]


def _wide_launches():
    """Kernel A's wide launches so far in this process, or None where the
    program has no such tally."""
    try:
        from ginkgo_tpu_torch.ops.spmv_banded import dia_spmv_wide_cuda
    except ImportError:
        return None
    return getattr(dia_spmv_wide_cuda, "launches", None)


def _record(run):
    try:
        from ginkgo_tpu_torch.log import record
    except ImportError:
        return None
    if run.system is None:
        return None
    stream = RhsStream(run.cell.traffic, run.system.n, SEED, run.device,
                       getattr(torch, run.cell.config["dtype"]))
    b = stream.rhs(0)
    on_card = run.device.type == "cuda"
    launches = _wide_launches() if on_card else None
    with record() as rec:
        run.system.solve(b)
        if on_card:
            torch.cuda.synchronize(run.device)
    iterations = sum(s.name == ITERATION and s.solve_id is not None
                     for s in rec.spans)
    if not iterations:
        return None
    counters = dict(rec.counters)
    if launches is not None:
        counters[WIDE_LAUNCHES] = _wide_launches() - launches
    return {"iterations": iterations,
            "spmvs": sum(s.name == EXCHANGE for s in rec.spans),
            "counters": counters}
