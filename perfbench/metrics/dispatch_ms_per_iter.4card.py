"""``dispatch_ms_per_iter`` in the four-card cell, whose time the host's speed sets while
the ranked loop dispatches through DTensor: reported there per layer,
moving ``peak_mem_gib`` (PERF.md, section 2)."""

from pathlib import Path

from perfbench.spec import load_module

read = load_module(Path(__file__).with_name("dispatch_ms_per_iter.py")).read
