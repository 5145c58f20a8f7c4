"""Reverse Cuthill-McKee reordering (``ginkgo_tpu/reorder/rcm.py`` in
torch).

Analog of ``include/ginkgo/core/reorder/rcm.hpp:71,175`` /
``core/reorder/rcm.cpp``: levelized BFS from a pseudo-peripheral vertex per
connected component, neighbors visited in increasing-degree order, final
ordering reversed.  Pure host graph work (Ginkgo also runs it on master for
the reference backend), the reference's code unchanged, so the
permutation is the JAX package's to the index; the product is a
Permutation LinOp on the matrix's device.
"""

from __future__ import annotations

import numpy as np

from ..device import matrix_data_and_device
from ..matrix.permutation import Permutation


def _adjacency(data):
    d = data.canonical()
    n = d.shape[0]
    import scipy.sparse as sp
    a = sp.csr_matrix((np.ones_like(d.values, dtype=np.int8),
                       (d.row_idx, d.col_idx)), shape=(n, n))
    a = ((a + a.T) > 0).tocsr()
    a.setdiag(0)
    a.eliminate_zeros()
    return a


def _bfs_levels(adj, start, order_by_degree=True):
    n = adj.shape[0]
    deg = np.diff(adj.indptr)
    visited = np.zeros(n, bool)
    visited[start] = True
    order = [start]
    frontier = [start]
    depth = 0
    while frontier:
        nxt = []
        for u in frontier:
            nbrs = adj.indices[adj.indptr[u]:adj.indptr[u + 1]]
            nbrs = [v for v in nbrs if not visited[v]]
            if order_by_degree:
                nbrs.sort(key=lambda v: (deg[v], v))
            for v in nbrs:
                visited[v] = True
                nxt.append(v)
        order.extend(nxt)
        frontier = nxt
        depth += 1
    return order, depth


def _pseudo_peripheral(adj, start):
    """George-Liu: repeat BFS from the last-discovered vertex until the
    eccentricity stops growing (one BFS per iteration)."""
    current = start
    order, depth = _bfs_levels(adj, current, order_by_degree=False)
    while True:
        last = order[-1]
        order, d2 = _bfs_levels(adj, last, order_by_degree=False)
        if d2 <= depth:
            return current
        current, depth = last, d2


def rcm_ordering(data) -> np.ndarray:
    """perm such that B = A[perm][:, perm] has reduced bandwidth
    (perm[i] = old index of new row i)."""
    adj = _adjacency(data)
    n = adj.shape[0]
    deg = np.diff(adj.indptr)
    visited = np.zeros(n, bool)
    order = []
    while len(order) < n:
        remaining = np.nonzero(~visited)[0]
        start = remaining[np.argmin(deg[remaining])]
        start = _pseudo_peripheral(adj, int(start))
        comp, _ = _bfs_levels(adj, start)
        comp = [v for v in comp if not visited[v]]
        visited[comp] = True
        order.extend(comp)
    return np.asarray(order[::-1], np.int64)


class Rcm:
    """Factory: ``Rcm.build().generate(A)`` -> Permutation."""

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A) -> Permutation:
        data, device = matrix_data_and_device(A)
        return Permutation.from_indices(rcm_ordering(data), device=device)
