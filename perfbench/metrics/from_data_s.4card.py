"""``from_data_s`` in the four-card cell: the seconds of
``DistributedMatrix.from_data``'s plan on the benchmark's process (rank
0), before any rank starts (``systems/dist_krylov.py``'s span)."""

from pathlib import Path

from perfbench.spec import load_module

read = load_module(Path(__file__).with_name("from_data_s.py")).read
