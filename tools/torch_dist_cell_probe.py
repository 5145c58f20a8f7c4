#!/usr/bin/env python3
"""The four-card cell's system beside the one-card 16-RHS cell's, on the
same right-hand sides.

    python3 tools/torch_dist_cell_probe.py [--seed 12345] [--blocks 3]

Builds the system of ``hpcg27-dist-cg-16rhs-4card``
(``perfbench/systems/dist_krylov.py``: 4 NCCL ranks led by this process,
one slab a card) with its set-up phases timed, solves the seed's first
``--blocks`` blocks, each timed, closes it and lists the processes it
left, then builds the one-card system of ``hpcg27-cg-16rhs`` and solves
the same blocks.  Prints one JSON line a phase, the card's name and power
limit first, and last each block's iterations by column on both and the
largest difference.  Needs 4 cards; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import spec  # noqa: E402
from perfbench.rhs import RhsStream  # noqa: E402

CELLS = ("hpcg27-dist-cg-16rhs-4card", "hpcg27-cg-16rhs")


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def children() -> list:
    """The live processes whose parent is this one."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == os.getpid() and fields[0] != "Z":
            out.append(int(entry))
    return out


def solve_blocks(cell, matrix, seed, blocks):
    spans = {}
    t = time.perf_counter()
    system = cell.module("systems").System(matrix, cell.config, "cuda",
                                           spans)
    setup = time.perf_counter() - t
    stream = RhsStream(cell.traffic, system.n, seed, "cuda",
                       getattr(torch, cell.config["dtype"]))
    t = time.perf_counter()
    system.solve(stream.rhs(-1))
    torch.cuda.synchronize()
    say("set-up", cell=cell.name, seconds=setup, warmup=time.perf_counter()
        - t, **spans)
    iterations = []
    for i in range(blocks):
        t = time.perf_counter()
        res = system.solve(stream.rhs(i))
        torch.cuda.synchronize()
        iterations.append(res.iterations.tolist())
        say("solve", cell=cell.name, block=i, ms=1e3 * (time.perf_counter()
                                                        - t),
            iterations=iterations[-1], converged=bool(res.converged.all()))
    close = getattr(system, "close", None)
    if close is not None:
        close()
    del system, res
    return iterations


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--blocks", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("torch_dist_cell_probe: needs 4 CUDA cards", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    say("card", cards=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    dist_cell, one_cell = (spec.load_cell(ROOT, c) for c in CELLS)
    t = time.perf_counter()
    matrix = dist_cell.module("matrices").generate(dist_cell.config)
    say("generate", seconds=time.perf_counter() - t)
    got = solve_blocks(dist_cell, matrix, args.seed, args.blocks)
    time.sleep(2)
    say("closed", children=children())
    want = solve_blocks(one_cell, matrix, args.seed, args.blocks)
    diff = max(abs(a - b) for g, w in zip(got, want) for a, b in zip(g, w))
    say("iterations", four_cards=got, one_card=want, largest_difference=diff)
    return 0


if __name__ == "__main__":
    sys.exit(main())
