"""``ops_per_iter`` in the four-card cell, on rank 0 (the process that runs
the window): the host ops an iteration that the ranked loop dispatches,
DTensor's wrapping of every vector op included (D3).  Its time the host's
speed sets, so it moves ``peak_mem_gib`` (PERF.md, section 2)."""

from pathlib import Path

from perfbench.spec import load_module

read = load_module(Path(__file__).with_name("ops_per_iter.py")).read
