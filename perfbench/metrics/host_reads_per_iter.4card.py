"""``host_reads_per_iter`` in the four-card cell, on rank 0: reported there
moving ``peak_mem_gib`` (PERF.md, section 2)."""

from pathlib import Path

from perfbench.spec import load_module

read = load_module(Path(__file__).with_name("host_reads_per_iter.py")).read
