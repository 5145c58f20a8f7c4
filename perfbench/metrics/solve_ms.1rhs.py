"""``solve_ms`` in the one-right-hand-side cells, whose time the host's speed
sets: reported per layer there (PERF.md, section 2)."""

from pathlib import Path

from perfbench.spec import load_module

read = load_module(Path(__file__).with_name("solve_ms.py")).read
