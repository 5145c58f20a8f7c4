"""ParILUT helpers (``ginkgo_tpu/factorization/par_ilut.py`` in torch).

Only the host lookup that ParILU shares with ParILUT is ported so far; the
threshold factorizations themselves are a later slice (ROADMAP.md, queue 1
item 10).
"""

from __future__ import annotations

import numpy as np


def _sorted_lookup(keys_sorted, vals, query, default=0.0):
    """Vectorized map lookup: keys_sorted ascending unique int64."""
    if keys_sorted.size == 0:
        return np.full(query.shape, default,
                       vals.dtype if vals.size else np.float64)
    pos = np.searchsorted(keys_sorted, query)
    pos_c = np.minimum(pos, keys_sorted.size - 1)
    hit = keys_sorted[pos_c] == query
    out = np.where(hit, vals[pos_c], default)
    return out
