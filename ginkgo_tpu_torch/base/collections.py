"""Base containers: segmented_array and index_set
(``ginkgo_tpu/base/collections.py`` in torch).

Analogs of ``include/ginkgo/core/base/segmented_array.hpp:56`` (CSR-style
ragged array: offsets + flat buffer) and ``index_set.hpp:56`` (sorted
interval set with global<->local mapping kernels,
``core/base/index_set_kernels.hpp:20-39``).  ``IndexSet`` is host numpy,
a copy of the reference's; ``SegmentedArray`` holds tensors on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .dtypes import as_torch_dtype


class SegmentedArray:
    """Ragged array of segments over one flat device buffer."""

    def __init__(self, offsets, buffer):
        self.offsets = offsets   # (num_segments + 1,) int64
        self.buffer = buffer     # (total,)

    @classmethod
    def from_sizes(cls, sizes, dtype=torch.float32, device=None):
        """Zero segments of the given sizes on ``device`` (``None``: the
        CUDA device)."""
        device = resolve_device(device)
        sizes = np.asarray(sizes, np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        return cls(offsets=torch.from_numpy(offsets).to(device),
                   buffer=torch.zeros(int(offsets[-1]),
                                      dtype=as_torch_dtype(dtype),
                                      device=device))

    @classmethod
    def from_segments(cls, segments, device=None):
        """The segments (array-likes) concatenated on ``device``."""
        device = resolve_device(device)
        arrays = [np.asarray(s) for s in segments]
        sizes = [a.shape[0] for a in arrays]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        buf = np.concatenate(arrays) if arrays else np.zeros(0)
        return cls(offsets=torch.from_numpy(offsets.astype(np.int64))
                   .to(device), buffer=torch.from_numpy(buf).to(device))

    @property
    def num_segments(self):
        return self.offsets.shape[0] - 1

    def segment(self, i):
        """Host-index access (slicing semantics)."""
        lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
        return self.buffer[lo:hi]

    def segment_ids(self):
        """(total,) segment id per buffer element (int32)."""
        total = self.buffer.shape[0]
        pos = torch.arange(total, device=self.offsets.device)
        return torch.searchsorted(self.offsets[1:], pos,
                                  right=True).to(torch.int32)

    def segment_sums(self):
        out = torch.zeros(self.num_segments, dtype=self.buffer.dtype,
                          device=self.buffer.device)
        return out.index_add_(0, self.segment_ids(), self.buffer)


class IndexSet:
    """Sorted interval set (host metadata): contiguous runs compressed to
    [begin, end) subsets with global<->local maps."""

    def __init__(self, size: int, indices=None):
        self.size = int(size)
        if indices is None or len(indices) == 0:
            self.begins = np.zeros(0, np.int64)
            self.ends = np.zeros(0, np.int64)
            self.offsets = np.zeros(1, np.int64)
            return
        idx = np.unique(np.asarray(indices, np.int64))
        if idx[0] < 0 or idx[-1] >= size:
            raise ValueError("indices out of range")
        breaks = np.nonzero(np.diff(idx) > 1)[0]
        starts = np.concatenate([[0], breaks + 1])
        stops = np.concatenate([breaks, [idx.size - 1]])
        self.begins = idx[starts]
        self.ends = idx[stops] + 1
        sizes = self.ends - self.begins
        self.offsets = np.concatenate([[0], np.cumsum(sizes)])

    # -- queries (index_set.hpp analogs) --------------------------------------
    @property
    def num_subsets(self) -> int:
        return self.begins.shape[0]

    def get_num_elems(self) -> int:
        return int(self.offsets[-1])

    def contains(self, global_idx) -> np.ndarray:
        g = np.asarray(global_idx, np.int64)
        pos = np.searchsorted(self.begins, g, side="right") - 1
        ok = pos >= 0
        pc = np.maximum(pos, 0)
        return ok & (g < self.ends[pc])

    def get_local_index(self, global_idx) -> np.ndarray:
        """global -> position within the set (-1 when absent)."""
        g = np.asarray(global_idx, np.int64)
        pos = np.searchsorted(self.begins, g, side="right") - 1
        ok = (pos >= 0)
        pc = np.maximum(pos, 0)
        ok &= g < self.ends[pc]
        local = self.offsets[pc] + (g - self.begins[pc])
        return np.where(ok, local, -1)

    def get_global_index(self, local_idx) -> np.ndarray:
        """position within the set -> global index (-1 when out of range)."""
        l = np.asarray(local_idx, np.int64)
        if self.get_num_elems() == 0:
            return np.full(l.shape, -1, np.int64)
        ok = (l >= 0) & (l < self.get_num_elems())
        lc = np.clip(l, 0, self.get_num_elems() - 1)
        sub = np.searchsorted(self.offsets[1:], lc, side="right")
        out = self.begins[sub] + (lc - self.offsets[sub])
        return np.where(ok, out, -1)

    def to_global_indices(self) -> np.ndarray:
        return np.concatenate(
            [np.arange(b, e) for b, e in zip(self.begins, self.ends)]
            or [np.zeros(0, np.int64)])
