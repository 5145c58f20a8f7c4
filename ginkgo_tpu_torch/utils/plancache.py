"""Pattern-keyed single-slot plan caches (the reference's symbolic-reuse
story, ``core/matrix/csr.cpp:50-51``: symbolic structures captured once,
numeric passes reuse them).

Device-resident setup plans (packed ParILUT/ParICT, packed trisolve,
ISAI pattern symbolics) cost seconds-to-minutes of host symbolics that
depend only on the sparsity PATTERN, so each keeps its most-recent plan
keyed on a sha1 digest of the pattern arrays plus whatever else the plan
content depends on (dtype kind, kernel tier, budgets).  Single slot per
key: packed streams reach GBs at n=262k level-2 universes, so an
unbounded cache would hoard host/device memory.

The cache stores rejects (value ``None``) too — declining a pattern is
itself an expensive decision worth remembering.
"""

from __future__ import annotations

import hashlib

import numpy as np


def pattern_digest(*arrays, ints=(), strs=()) -> bytes:
    """sha1 over pattern arrays + scalar ints + strings.  EVERYTHING a
    cached plan's content depends on must be included — a pattern-only
    digest once let an f32 trisolve plan silently serve a complex
    factor."""
    h = hashlib.sha1()
    if ints:
        h.update(np.asarray(list(ints), np.int64).tobytes())
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    for s in strs:
        h.update(str(s).encode())
        h.update(b"\x00")
    return h.digest()


class SingleSlotCache:
    """One (digest, value) slot per key; ``MISS`` distinguishes a miss
    from a cached ``None`` (reject)."""

    MISS = object()

    def __init__(self):
        self._slots = {}

    def get(self, key, digest):
        hit = self._slots.get(key)
        if hit is not None and hit[0] == digest:
            return hit[1]
        return self.MISS

    def put(self, key, digest, value):
        self._slots[key] = (digest, value)
        return value

    def clear(self):
        self._slots.clear()
