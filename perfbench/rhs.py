"""The one generator of right-hand sides, driven by a traffic file.

A traffic file (``traffic/<name>.json``) sets:

* ``columns``: right-hand sides a solve takes together (one (n, k) block);
* ``entries``: ``normal`` (unit normal) or ``ones`` (Ginkgo's benchmark
  default);
* ``loop``: ``closed`` (the next solve starts when the last returns), the
  only loop the harness runs.

Solve ``i`` of seed ``s`` gets the block drawn on the device by a
``torch.Generator`` seeded from ``(s, i)`` alone, so any block can be drawn
again after the window to check its answer.  The warm-up draws ``i = -1``.
"""

from __future__ import annotations

import numpy as np
import torch

ENTRIES = ("normal", "ones")


class RhsStream:
    def __init__(self, traffic: dict, n: int, seed: int, device, dtype):
        if traffic.get("loop", "closed") != "closed":
            raise ValueError(f"unknown loop {traffic['loop']!r}")
        if traffic["entries"] not in ENTRIES:
            raise ValueError(f"unknown entries {traffic['entries']!r}")
        self.shape = (n, int(traffic["columns"]))
        self.entries = traffic["entries"]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device)

    def rhs(self, i: int) -> torch.Tensor:
        """The (n, columns) block of solve ``i``."""
        if self.entries == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=self.device)
        state = np.random.SeedSequence([self.seed % 2**64, i + 1])
        self.gen.manual_seed(int(state.generate_state(1, np.uint64)[0]))
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        return out.normal_(generator=self.gen)
