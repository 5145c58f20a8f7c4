"""The comparison that decides ``correct``.

After the window, with the program's state freed, the plain reference
judges a sample of the window's solves, drawn from the seed:

* ``failed``: solves of the window that raised, did not converge or
  stagnated (limit 0);
* ``relres``: the largest true relative residual ||b - A x|| / ||b|| of a
  sampled column, in float64.  Its limit is the one the configuration
  states, its criterion ``ResidualNorm(tol)``, which the program evaluates
  in its own precision: tol plus what that evaluation may be off by,
  (row nonzeros + 1) u (||b|| + || |A| |x| ||) / ||b|| with u the unit
  roundoff of the configuration's dtype, the least over the sampled
  columns;
* ``x_gap``: the largest ||x - x_ref|| / ||x_ref|| of a sampled column,
  where ``x_ref`` is the float64 reference's iterate after as many
  iterations as the program reports for that column.  It holds the
  iterate's precision and, through it, the reported iteration count.

``x_gap``'s limit lives in ``workloads/<cell>.json`` under ``limits``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Reservoir:
    """A uniform sample of ``size`` solves of the window, drawn from the
    seed (Algorithm R): ``offer(i, item)`` for every solve in order."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([int(seed) % 2**64, 0x5eed])
        self.items: dict[int, object] = {}
        self.slots: list[int] = []

    def offer(self, i: int, item):
        if len(self.slots) < self.size:
            self.slots.append(i)
            self.items[i] = item
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.size:
            del self.items[self.slots[j]]
            self.slots[j] = i
            self.items[i] = item


def solve_ok(res) -> bool:
    """A solve that returned, converged in every column and did not
    stagnate."""
    return bool(res.converged.all()) and not (
        res.stagnated is not None and bool(res.stagnated.any()))


def compare(reference, op, config, cell_check, samples, rhs, failed):
    """[(name, value, limit)] of a window: ``samples`` maps a solve's index
    to its (x, iterations); ``rhs(i)`` draws the block of solve i again."""
    relres, slack, x_gap = [], [], []
    u = torch.finfo(getattr(torch, config["dtype"])).eps / 2
    for i, (x, iters) in sorted(samples.items()):
        b = rhs(i).to(torch.float64)
        x64 = x.to(torch.float64)
        b_norm = torch.linalg.vector_norm(b, dim=0)
        relres.append(float(reference.true_relres(op, b, x64).max()))
        spread = (torch.linalg.vector_norm(b.abs(), dim=0)
                  + torch.linalg.vector_norm(op.abs_apply(x64.abs()), dim=0))
        slack.append(float(((op.max_row_nnz + 1) * u * spread
                            / b_norm).min()))
        ref = reference.solve(op, b, config, "float64",
                              snapshot=iters.tolist())
        gap = (torch.linalg.vector_norm(x64 - ref.x, dim=0)
               / torch.linalg.vector_norm(ref.x, dim=0))
        x_gap.append(float(gap.max()))
    worst = (lambda v: max(v) if v else math.inf)
    return [("failed", failed, 0),
            ("relres", worst(relres), config["tol"] + min(slack, default=0)),
            ("x_gap", worst(x_gap), cell_check["limits"]["x_gap"])]


def verdict(rows) -> bool:
    """Every number at or under its limit (a NaN is not)."""
    return all(v <= lim for _, v, lim in rows)
