"""IndexMap — global↔local mapping including remote (ghost) indices.

Analog of ``include/ginkgo/core/distributed/index_map.hpp`` (map_to_local:82,
get_remote_global_idxs:142, get_remote_local_idxs:158,
get_remote_target_ids:166).  Host-side build-time metadata: given the set of
non-owned global column indices a part touches, it assigns compressed ghost
ids and records, per remote part, which of *its* rows must be shipped —
turning Ginkgo's runtime communication pattern into static send/recv index
arrays for the halo exchange.  A copy of
``ginkgo_tpu/distributed/index_map.py``.
"""

from __future__ import annotations

import numpy as np

from .partition import Partition


class IndexMap:
    """Per-part ghost bookkeeping for one (row) partition."""

    def __init__(self, part: Partition, rank: int,
                 remote_global: np.ndarray):
        """remote_global: sorted unique global indices this part needs but
        does not own."""
        self.partition = part
        self.rank = rank
        self.remote_global = np.asarray(remote_global, np.int64)
        self.remote_owner = part.owner_of(self.remote_global)
        self.remote_local = (self.remote_global
                             - part.ranges[self.remote_owner])

    @classmethod
    def build(cls, part: Partition, rank: int,
              touched_global: np.ndarray) -> "IndexMap":
        touched = np.unique(np.asarray(touched_global, np.int64))
        lo, hi = part.ranges[rank], part.ranges[rank + 1]
        remote = touched[(touched < lo) | (touched >= hi)]
        return cls(part, rank, remote)

    # -- queries (index_map.hpp analogs) --------------------------------------
    @property
    def num_ghosts(self) -> int:
        return self.remote_global.shape[0]

    def get_remote_global_idxs(self) -> np.ndarray:
        return self.remote_global

    def get_remote_local_idxs(self) -> np.ndarray:
        """Ghosts as local rows of their owners, segmented by target."""
        return self.remote_local

    def get_remote_target_ids(self) -> np.ndarray:
        return np.unique(self.remote_owner)

    def map_to_local(self, global_idxs) -> np.ndarray:
        """Owned rows -> [0, local); ghosts -> local_size + ghost_id."""
        g = np.asarray(global_idxs, np.int64)
        lo, hi = (self.partition.ranges[self.rank],
                  self.partition.ranges[self.rank + 1])
        owned = (g >= lo) & (g < hi)
        out = np.empty(g.shape, np.int64)
        out[owned] = g[owned] - lo
        gr = g[~owned]
        pos = np.searchsorted(self.remote_global, gr)
        if self.num_ghosts == 0:
            bad = np.ones(gr.shape, bool)
        else:
            pos_c = np.minimum(pos, self.num_ghosts - 1)
            bad = (pos >= self.num_ghosts) | (self.remote_global[pos_c] != gr)
        if bad.any():
            from ..base.exceptions import OutOfBoundsError
            raise OutOfBoundsError(
                f"indices not in map: {gr[bad][:5]} ...")
        out[~owned] = (hi - lo) + pos
        return out

    def map_to_global(self, local_idxs) -> np.ndarray:
        """Inverse of map_to_local (``index_map.hpp`` map_to_global):
        [0, local) -> owned global rows; local_size + ghost_id -> the
        ghost's global index."""
        li = np.asarray(local_idxs, np.int64)
        lo, hi = (self.partition.ranges[self.rank],
                  self.partition.ranges[self.rank + 1])
        local_size = hi - lo
        if (li < 0).any() or (li >= local_size + self.num_ghosts).any():
            from ..base.exceptions import OutOfBoundsError
            raise OutOfBoundsError(
                "local indices out of range for this map")
        out = np.empty(li.shape, np.int64)
        owned = li < local_size
        out[owned] = li[owned] + lo
        out[~owned] = self.remote_global[li[~owned] - local_size]
        return out
