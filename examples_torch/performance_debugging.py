"""performance-debugging + ginkgo-overhead examples: ProfilerHook's summary
of the library's spans (the matrix's planning and upload, each solve, its
iterations, checks, host reads and steps; inclusive and self host time)
and its host-read counter, plus the library's overhead on an apply: the
public ``apply`` (rank and dimension checks, the logger hook) against the
operator's bare ``_apply`` on the same input, each call ended by a sync."""

import os as _os, sys as _sys
_sys.path[:0] = [_d := _os.path.dirname(_os.path.abspath(__file__)),
                 _os.path.dirname(_d)]  # examples dir + repo root
from _example_setup import DTYPE, device_of

import time

import torch

import ginkgo_tpu_torch as gtt
from ginkgo_tpu_torch.log import ProfilerHook, capture
from ginkgo_tpu_torch.solver import Cg
from ginkgo_tpu_torch.stop import Iteration, ResidualNorm
from ginkgo_tpu_torch.utils.generators import stencil_2d


def _per_call(fn, dev, reps=10):
    """Seconds a call, each ended by a sync of ``dev``, after a warm-up."""
    def once():
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    once()
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    return (time.perf_counter() - t0) / reps


def main(device=None):
    dev = device_of(device)
    data = stencil_2d(16, points=5)
    with capture(ProfilerHook()) as prof:
        A = gtt.Csr.from_data(data, device=dev)
        b = torch.ones(A.shape[0], dtype=DTYPE, device=dev)
        solver = Cg.build(criteria=Iteration(200) | ResidualNorm(1e-9)
                          ).generate(A)
        for _ in range(3):
            solver.apply(b)
    print(prof.write_summary())
    summary = prof.create_summary()
    assert summary["solver.cg"][0] == 3 and "setup.plan" in summary
    reads = prof.recording.counters["host_reads"]
    iterations = summary["loop.iteration"][0]
    print(f"{reads} host reads over {iterations} iterations")

    # ginkgo-overhead analog: what the public apply adds to the kernel call
    b2 = b[:, None]
    public = _per_call(lambda: A.apply(b2), dev)
    bare = _per_call(lambda: A._apply(b2), dev)
    print(f"apply overhead: public {public * 1e6:.0f}us vs bare "
          f"{bare * 1e6:.0f}us")
    assert public <= bare * 5  # the checks must not dominate an apply
    return {"apply_overhead": public / max(bare, 1e-12),
            "apply_overhead_bound": 5.0}


if __name__ == "__main__":
    main()
