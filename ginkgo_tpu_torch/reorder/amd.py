"""Approximate minimum degree reordering (``ginkgo_tpu/reorder/amd.py``
in torch).

Analog of ``include/ginkgo/core/reorder/amd.hpp:36`` /
``core/reorder/amd.cpp`` (itself a reimplementation of SuiteSparse AMD).

Primary path: the native C++ quotient-graph AMD (``gt_amd_order``) —
eliminated pivots become elements, approximate external degrees via the
one-pass |Le \\ Lp| trick, supervariable merging by adjacency hashing,
aggressive element absorption (the Amestoy-Davis-Duff algorithm, so
n=100k orders in seconds).  Fallback: exact minimum degree on the
elimination graph (Python sets; small matrices only).
"""

from __future__ import annotations

import heapq

import numpy as np

from ..device import matrix_data_and_device
from ..matrix.permutation import Permutation
from ..native import amd_order_native


def symmetric_adjacency(d):
    """CSR (ptr, adj) of the symmetrized pattern of canonical ``d``
    without its diagonal, the graph the native orderings take."""
    n = d.shape[0]
    r = d.row_idx.astype(np.int64)
    c = d.col_idx.astype(np.int64)
    off = r != c
    rr = np.concatenate([r[off], c[off]])
    cc = np.concatenate([c[off], r[off]])
    key = np.unique(rr * n + cc)
    rr, cc = key // n, key % n
    ptr = np.searchsorted(rr, np.arange(n + 1)).astype(np.int64)
    return ptr, cc


def amd_ordering(data) -> np.ndarray:
    d = data.canonical()
    n = d.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    perm = amd_order_native(n, *symmetric_adjacency(d))
    if perm is not None:
        return perm
    return _md_ordering_python(d)


def _md_ordering_python(d) -> np.ndarray:
    n = d.shape[0]
    adj = [set() for _ in range(n)]
    for i, j in zip(d.row_idx, d.col_idx):
        i, j = int(i), int(j)
        if i != j:
            adj[i].add(j)
            adj[j].add(i)
    alive = np.ones(n, bool)
    order = []
    heap = [(len(adj[v]), v) for v in range(n)]
    heapq.heapify(heap)
    while len(order) < n:
        deg, v = heapq.heappop(heap)
        if not alive[v] or deg != len(adj[v]):
            continue   # stale entry
        alive[v] = False
        order.append(v)
        nbrs = [u for u in adj[v] if alive[u]]
        # eliminate v: clique its neighbors
        for u in nbrs:
            adj[u].discard(v)
            for w in nbrs:
                if w != u:
                    adj[u].add(w)
            heapq.heappush(heap, (len(adj[u]), u))
    return np.asarray(order, np.int64)


class Amd:
    """Factory: ``Amd.build().generate(A)`` -> Permutation."""

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> Permutation:
        data, device = matrix_data_and_device(A)
        return Permutation.from_indices(amd_ordering(data), device=device)
