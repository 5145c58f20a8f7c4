"""What one cell is made of, found by the names in ``BENCHMARK.json``.

* ``configs/<config>.json`` (the file that ``BENCHMARK.json`` names): the
  matrix generator and its sizes, the dtype, the solver and its settings,
  the ``system`` adapter and the ``reference`` that judge it;
* ``traffic/<traffic>.json``: the parameters of the right-hand sides,
  read by ``rhs.py``;
* ``workloads/<cell>.json``: what the check of the cell compares (the
  sample of solves and each number's limit);
* ``metrics/<metric>.py``: one reader a metric, ``read(run)``;
* ``matrices/<generator>.py``, ``systems/<system>.py`` and
  ``reference/<reference>.py``: the code those files name.

A later cell, configuration or metric is new files plus new entries in
``BENCHMARK.json``; nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

DIR = "perfbench"     # the benchmark's folder in a checkout


def load_module(path: Path):
    """Import the Python file ``path`` under a name of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    name = "perfbench_file_" + re.sub(r"\W", "_", str(path.resolve()))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    dir: Path            # the checkout's benchmark folder
    chips: int
    config: dict
    traffic: dict
    check: dict
    metrics: dict        # name -> BENCHMARK.json entry, this cell's only
    trace_metrics: dict  # the same for the per-layer metrics

    def module(self, kind: str):
        """The ``matrices``, ``systems`` or ``reference`` module that the
        configuration names."""
        key = {"matrices": "generator", "systems": "system",
               "reference": "reference"}[kind]
        return load_module(self.dir / kind / f"{self.config[key]}.py")

    def reader(self, metric: str):
        """The ``read(run)`` function of ``metrics/<metric>.py``."""
        return load_module(self.dir / "metrics" / f"{metric}.py").read


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` where
    it has them, else every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(root, name: str) -> Cell:
    """The cell ``name`` of the checkout at ``root``."""
    root = Path(root)
    here = root / DIR
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {', '.join(sorted(cells))})")
    w = cells[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(root / config_entry["file"])
    e2e = {m["name"]: m for m in bench["end_to_end"]
           if _applies(m, name, ())}
    per_layer = {m["name"]: m for m in bench["per_layer"]
                 if _applies(m, name, e2e)}
    return Cell(name=name, dir=here, chips=int(w["chips"]), config=config,
                traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
                check=_json(here / "workloads" / f"{name}.json"),
                metrics=e2e, trace_metrics=per_layer)
