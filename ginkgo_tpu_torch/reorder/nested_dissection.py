"""Nested dissection reordering
(``ginkgo_tpu/reorder/nested_dissection.py`` in torch).

Analog of ``include/ginkgo/core/reorder/nested_dissection.hpp:40-47``
(a METIS wrapper, optional dependency).  METIS is not available in this
environment, so the primary path is a self-contained METIS-style
multilevel ND in the native C++ tier (``gt_nd_order``): heavy-edge
matching coarsening, greedy graph-growing initial bisection, boundary FM
refinement at every uncoarsening level, vertex separators by greedy cover
of the refined cut, and AMD on the leaf blocks.  Fallback (no native
toolchain): recursive bisection via BFS levelization — same
divide-and-conquer fill reduction, lower separator quality.  If `pymetis`
shows up, this is the seam to swap it in.
"""

from __future__ import annotations

import numpy as np

from ..device import matrix_data_and_device
from ..matrix.permutation import Permutation
from ..native import nd_order_native
from .amd import symmetric_adjacency
from .rcm import _adjacency


def _bisect(adj, nodes):
    """Split `nodes` (list) into (left, right, separator) via BFS levels."""
    sub = set(nodes)
    start = _pseudo_peripheral_sub(adj, nodes[0], sub)
    # BFS levels restricted to the subgraph
    level = {start: 0}
    frontier = [start]
    order = [start]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj.indices[adj.indptr[u]:adj.indptr[u + 1]]:
                if v in sub and v not in level:
                    level[v] = level[u] + 1
                    nxt.append(v)
                    order.append(v)
        frontier = nxt
    for v in nodes:            # disconnected pieces -> left half
        if v not in level:
            level[v] = 0
    depth = max(level.values())
    mid = depth // 2
    left = [v for v in nodes if level[v] < mid]
    sep = [v for v in nodes if level[v] == mid]
    right = [v for v in nodes if level[v] > mid]
    return left, right, sep


def _pseudo_peripheral_sub(adj, start, sub):
    current = start
    for _ in range(4):
        level = {current: 0}
        frontier = [current]
        last = current
        while frontier:
            nxt = []
            for u in frontier:
                for v in adj.indices[adj.indptr[u]:adj.indptr[u + 1]]:
                    if v in sub and v not in level:
                        level[v] = level[u] + 1
                        nxt.append(v)
                        last = v
            frontier = nxt
        if last == current:
            break
        current = last
    return current


def nested_dissection_ordering(data, min_size: int = 16) -> np.ndarray:
    d = data.canonical()
    n = d.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    # primary path: native multilevel ND (coarsening + FM-refined vertex
    # separators + AMD leaf blocks)
    perm = nd_order_native(n, *symmetric_adjacency(d))
    if perm is not None:
        return perm
    return _nested_dissection_python(data, min_size)


def _nested_dissection_python(data, min_size: int = 16) -> np.ndarray:
    adj = _adjacency(data)
    n = adj.shape[0]

    def rec(nodes):
        if len(nodes) <= min_size:
            return list(nodes)
        left, right, sep = _bisect(adj, list(nodes))
        if not left or not right:
            return list(nodes)
        return rec(left) + rec(right) + list(sep)

    order = rec(list(range(n)))
    return np.asarray(order, np.int64)


class NestedDissection:
    def __init__(self, min_size: int = 16):
        self.min_size = min_size

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> Permutation:
        data, device = matrix_data_and_device(A)
        return Permutation.from_indices(
            nested_dissection_ordering(data, self.min_size), device=device)
