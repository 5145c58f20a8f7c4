"""Partition — global row space → contiguous ranges → owning part.

Analog of ``include/ginkgo/core/distributed/partition.hpp:80,138,150,229``:
``build_from_global_size_uniform``, ``build_from_contiguous``,
``build_from_mapping``.  Partition metadata is host-side (numpy) — it is
build-time information that turns into *static* gather/scatter index arrays
for the device tier (SURVEY.md §7: "Partition/IndexMap as host-side metadata
producing static send/recv index arrays").

Every part is padded to a common ``local_size`` so the parts are
shape-uniform (each part's arrays stack on a leading part axis);
``to_padded`` / ``from_padded`` convert between the natural global layout
and the padded layout (padded slots are identically zero).  A copy of
``ginkgo_tpu/distributed/partition.py``: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import numpy as np


class Partition:
    """Contiguous row ranges, one per part."""

    def __init__(self, ranges: np.ndarray):
        """ranges: (num_parts + 1,) offsets; part p owns
        [ranges[p], ranges[p+1])."""
        self.ranges = np.asarray(ranges, np.int64)
        if (np.diff(self.ranges) < 0).any():
            raise ValueError("partition ranges must be non-decreasing")

    # -- constructors (partition.hpp:138-229 analogs) ------------------------
    @classmethod
    def build_from_global_size_uniform(cls, num_parts: int,
                                       global_size: int) -> "Partition":
        base = global_size // num_parts
        rem = global_size % num_parts
        sizes = np.full(num_parts, base, np.int64)
        sizes[:rem] += 1
        return cls(np.concatenate([[0], np.cumsum(sizes)]))

    @classmethod
    def build_from_contiguous(cls, ranges) -> "Partition":
        return cls(np.asarray(ranges))

    @classmethod
    def build_from_mapping(cls, mapping, num_parts: int) -> "Partition":
        """mapping: (global_size,) part id per row; must be contiguous
        blocks (Ginkgo supports general mappings via an implicit reorder —
        here non-contiguous mappings raise, reorder first)."""
        mapping = np.asarray(mapping)
        ranges = np.zeros(num_parts + 1, np.int64)
        counts = np.bincount(mapping, minlength=num_parts)
        ranges[1:] = np.cumsum(counts)
        # verify contiguity
        expect = np.repeat(np.arange(num_parts), counts)
        if not np.array_equal(np.sort(mapping), mapping) or \
                not np.array_equal(expect, mapping):
            raise ValueError("build_from_mapping requires contiguous blocks;"
                             " apply a reordering first")
        return cls(ranges)

    # -- queries --------------------------------------------------------------
    @property
    def num_parts(self) -> int:
        return self.ranges.shape[0] - 1

    @property
    def global_size(self) -> int:
        return int(self.ranges[-1])

    @property
    def local_size(self) -> int:
        """Padded uniform per-part size."""
        return int(np.diff(self.ranges).max()) if self.num_parts else 0

    def part_sizes(self) -> np.ndarray:
        return np.diff(self.ranges)

    def has_connected_parts(self) -> bool:
        """True when every part's rows form one contiguous block
        (``partition.hpp`` query).  Always true here: this Partition is
        one-range-per-part by construction (general multi-range mappings
        must be reordered first — see build_from_mapping)."""
        return True

    def has_ordered_parts(self) -> bool:
        """True when part ids appear in ascending global-row order
        (``partition.hpp`` query) — true by construction, as above."""
        return True

    def owner_of(self, global_rows) -> np.ndarray:
        return np.searchsorted(self.ranges, np.asarray(global_rows),
                               side="right") - 1

    def to_local(self, global_rows) -> np.ndarray:
        """Local index within the owning part."""
        g = np.asarray(global_rows)
        return g - self.ranges[self.owner_of(g)]

    # -- padded sharded layout helpers ---------------------------------------
    @property
    def padded_size(self) -> int:
        return self.num_parts * self.local_size

    def padded_slot(self, global_rows) -> np.ndarray:
        """Position of each global row in the padded (P*local_size) layout."""
        g = np.asarray(global_rows)
        owner = self.owner_of(g)
        return owner * self.local_size + (g - self.ranges[owner])

    def to_padded(self, x: np.ndarray) -> np.ndarray:
        """(global_size, ...) -> (padded_size, ...) with zero-padded slots."""
        x = np.asarray(x)
        out = np.zeros((self.padded_size,) + x.shape[1:], x.dtype)
        out[self.padded_slot(np.arange(self.global_size))] = x
        return out

    def from_padded(self, xp) -> np.ndarray:
        xp = np.asarray(xp)
        return xp[self.padded_slot(np.arange(self.global_size))]
