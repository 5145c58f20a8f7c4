"""Shared device primitives (``ginkgo_tpu/ops/components.py`` in torch).

Analogs of ``core/components/`` (prefix_sum, reduce_array, bitvector,
disjoint_sets, format conversion helpers).  Most are single torch ops on
the tensors' device — they exist as named functions so algorithm code
reads like the reference and the device mapping is centralized.
``DisjointSets``, ``RangeMinimumQuery`` and ``AddressablePriorityQueue``
serve host symbolics and stay numpy, as in the reference.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch


def prefix_sum_nonnegative(x):
    """Exclusive prefix sum (``prefix_sum_kernels`` analog): out[i] =
    sum(x[:i]); returns (out, total)."""
    c = torch.cumsum(x, 0)
    return torch.cat([c.new_zeros(1), c[:-1]]), c[-1]


def reduce_add_array(x, init=0):
    """``reduce_array`` analog."""
    return torch.sum(x) + init


_SEGMENT_REDUCE = {"max": "amax", "min": "amin"}


def segment_reduce(values, segment_ids, num_segments, op="add"):
    """Per-segment sum, max or min of ``values`` (``segment_ids`` need not
    be sorted).  An empty segment holds the identity of the reduction, as
    ``jax.ops.segment_*`` gives: 0, the lowest or the highest value of the
    type."""
    ids = segment_ids.long()
    shape = (num_segments,) + tuple(values.shape[1:])
    if op == "add":
        return values.new_zeros(shape).index_add_(0, ids, values)
    if op not in _SEGMENT_REDUCE:
        raise ValueError(f"unknown segment op {op!r}")
    if values.is_floating_point():
        init = -float("inf") if op == "max" else float("inf")
    else:
        info = torch.iinfo(values.dtype)
        init = info.min if op == "max" else info.max
    out = values.new_full(shape, init)
    index = ids.reshape((-1,) + (1,) * (values.ndim - 1)).expand_as(values)
    return out.scatter_reduce_(0, index, values, _SEGMENT_REDUCE[op])


_WORD_MASK = 0xFFFFFFFF


class Bitvector:
    """Packed bitset with rank queries (``core/components/bitvector.hpp``):
    32-bit words (held in int64, since torch has no uint32 arithmetic on
    every device) + popcount-based rank, on the bits' device."""

    def __init__(self, bits):
        bits = torch.as_tensor(bits).to(torch.bool)
        self.size = bits.shape[0]
        pad = (-self.size) % 32
        padded = torch.nn.functional.pad(bits, (0, pad)).reshape(-1, 32)
        weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
            << torch.arange(32, device=bits.device)
        self.words = (padded.to(torch.int64) * weights).sum(dim=1)
        counts = padded.sum(dim=1, dtype=torch.int32)
        self.rank_offsets = torch.cat(
            [counts.new_zeros(1), torch.cumsum(counts, 0)[:-1].to(
                torch.int32)])

    def get(self, i):
        i = torch.as_tensor(i, device=self.words.device)
        word = self.words[i // 32]
        return ((word >> (i % 32)) & 1).to(torch.bool)

    def rank(self, i):
        """#set bits strictly before position i."""
        i = torch.as_tensor(i, device=self.words.device)
        w = i // 32
        off = i % 32
        mask = (torch.ones_like(off) << off) - 1
        partial = _popcount(self.words[w] & mask)
        return self.rank_offsets[w] + partial.to(torch.int32)


def _popcount(x):
    """Set bits of each 32-bit word held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _WORD_MASK) >> 24


class DisjointSets:
    """Union-find (``core/components/disjoint_sets.hpp``) — host-side, used
    by aggregation/elimination-forest style symbolics."""

    def __init__(self, n):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, np.int8)

    def find(self, x):
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:     # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        return ra

    def num_sets(self):
        return int(sum(1 for i in range(len(self.parent))
                       if self.find(i) == i))


class RangeMinimumQuery:
    """Sparse-table RMQ (``core/components/range_minimum_query.hpp``):
    O(n log n) build, O(1) min-index queries — host-side (consumed by
    elimination-tree style symbolics)."""

    def __init__(self, values):
        v = np.asarray(values)
        n = v.shape[0]
        levels = max(1, n.bit_length())
        self.v = v
        self.idx = [np.arange(n, dtype=np.int64)]
        for k in range(1, levels):
            half = 1 << (k - 1)
            prev = self.idx[-1]
            if n - (1 << k) + 1 <= 0:
                break
            a = prev[: n - (1 << k) + 1]
            b = prev[half: half + n - (1 << k) + 1]
            self.idx.append(np.where(v[a] <= v[b], a, b))

    def argmin(self, lo: int, hi: int) -> int:
        """Index of the minimum of values[lo:hi] (hi exclusive)."""
        if hi <= lo:
            raise ValueError("empty range")
        span = hi - lo
        k = span.bit_length() - 1
        a = self.idx[k][lo]
        b = self.idx[k][hi - (1 << k)]
        return int(a if self.v[a] <= self.v[b] else b)

    def min(self, lo: int, hi: int):
        return self.v[self.argmin(lo, hi)]


class AddressablePriorityQueue:
    """Min-heap with update-key by handle
    (``core/components/addressable_pq.hpp``) — host-side, used by
    Dijkstra/MC64-style shortest-path symbolics."""

    def __init__(self):
        self._heap = []          # (key, seq, handle)
        self._current = {}       # handle -> key
        self._seq = 0

    def insert(self, handle, key):
        self._current[handle] = key
        heapq.heappush(self._heap, (key, self._seq, handle))
        self._seq += 1

    update_key = insert          # lazy-deletion update

    def pop_min(self):
        while self._heap:
            key, _, handle = heapq.heappop(self._heap)
            if self._current.get(handle) == key:
                del self._current[handle]
                return handle, key
        raise IndexError("empty priority queue")

    def __len__(self):
        return len(self._current)

    def __contains__(self, handle):
        return handle in self._current


def convert_idxs_to_ptrs(idxs, num_rows):
    """Row indices -> CSR row pointers (format_conversion_kernels); an
    index outside [0, num_rows) is dropped, as the reference's
    ``mode="drop"`` scatter does."""
    idxs = torch.as_tensor(idxs).long()
    keep = (idxs >= 0) & (idxs < num_rows)
    counts = torch.bincount(idxs[keep] + 1, minlength=num_rows + 1)
    return torch.cumsum(counts, 0)


def convert_ptrs_to_idxs(ptrs, nnz):
    """CSR row pointers -> row indices."""
    ptrs = torch.as_tensor(ptrs)
    return torch.searchsorted(
        ptrs[1:], torch.arange(nnz, dtype=ptrs.dtype, device=ptrs.device),
        right=True).to(torch.int32)
