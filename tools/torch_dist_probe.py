#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s distributed phases alone on a CUDA card.

    python3 tools/torch_dist_probe.py

Builds the kernels, then what those phases reuse from the earlier ones:
the nx=160 27-point stencil (f32, ``banded``) with its serial Jacobi-CG
(``main_banded``, twice: the second, warm solve gives the iterations and
ms per iteration the distributed solve is held to) and the ILU system's
FEM matrix with its bare BiCGSTAB's iterations; then ``dist_match``,
``main_dist_banded``, ``main_dist_neighborhood``, ``main_dist_packed``,
``main_dist_schwarz``, ``main_dist_2d``, ``df64_dist``,
``cli_distributed`` and ``examples_distributed``, each printing its JSON
line as in the whole script, and last the kernels' launches over those
paths.  Prints the card's name and power limit first; imports nothing of
JAX.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import ginkgo_tpu_torch as gtt  # noqa: E402
from ginkgo_tpu_torch.ops import _cuda  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_dist_probe: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    _cuda.build()
    cs.say("build", seconds=time.perf_counter() - t0)
    d_banded = cs.stencil_3d(cs.BANDED_NX, points=27)
    Ab = gtt.Csr.from_data(d_banded, dtype=np.float32)
    # the first solve warms the card (its first launches, the caching
    # allocator); the second's ms per iteration is the one compared
    for _ in range(2):
        _, banded_iters, _, banded_ms = cs.main_path("banded", Ab, "banded",
                                                     "dia_spmv")
    d_ilu = cs.build_matrix_data(cs.ILU_CASE)
    Ai = gtt.Csr.from_data(d_ilu, dtype=np.float32)
    bare = cs.bare_solve(Ai, cs.Bicgstab, cs.ILU_TOL, cap=1000)
    cs.say("bare_bicgstab", **bare)
    runs = cs.distributed_phases(d_banded, Ab, banded_iters, banded_ms,
                                 d_ilu, Ai, bare["iterations"])
    runs += cs.examples_distributed()
    print(json.dumps({"launches": {name: sum(r[name] for r in runs)
                                   for name in cs.COUNTERS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
