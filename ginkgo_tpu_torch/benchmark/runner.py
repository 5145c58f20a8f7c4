"""Benchmark test cases (``ginkgo_tpu/benchmark/runner.py`` in torch).

Only ``build_matrix_data`` is ported so far, with its generated cases: the
stencils and the unstructured FEM class.  The generator code is the JAX
package's, so the same case and seed give the same matrix.
"""

from __future__ import annotations

import numpy as np

from ..base.matrix_data import MatrixData
from ..utils.generators import stencil_2d, stencil_3d


def build_matrix_data(case: dict) -> MatrixData:
    """Test case -> MatrixData: {'stencil': '5pt|9pt|7pt|27pt', 'size':
    edge} or {'fem': n[, 'spread': 600, 'per_row': 18, 'offscale': 0.1,
    'sym': bool, 'seed': 5]} — the generated unstructured FEM class
    (random column offsets with mesh locality, diagonally dominant
    values).  MatrixMarket files and RCM reordering are later slices."""
    if "filename" in case:
        raise NotImplementedError(
            "MatrixMarket test cases need base/mtx_io.py, which a later "
            "slice of the port brings (ROADMAP.md, queue 1 item 1: mtx_io)")
    if case.get("rcm"):
        raise NotImplementedError(
            "'rcm' test cases need the reorderings, which a later slice of "
            "the port brings (ROADMAP.md, queue 1 item 9: reorder)")
    if "fem" in case:
        n = int(case["fem"])
        spread = int(case.get("spread", 600))
        per = int(case.get("per_row", 18))
        rng = np.random.default_rng(int(case.get("seed", 5)))
        block = 128
        n_off = max(2, int(round(per / 0.6)))
        offs = rng.integers(-spread, spread, (-(-n // block), n_off))
        pick = rng.random((n, n_off)) < 0.6
        r = np.repeat(np.arange(n), n_off).reshape(n, n_off)
        c = np.clip(r + offs[np.arange(n) // block], 0, n - 1)
        rows, cols = r[pick], c[pick]
        key = np.unique(rows * n + cols)
        rows, cols = key // n, key % n
        rows = np.concatenate([rows, np.arange(n)])
        cols = np.concatenate([cols, np.arange(n)])
        off = float(case.get("offscale", 0.1))
        vals = np.concatenate([off * rng.standard_normal(key.size),
                               np.full(n, 8.0)])
        d = MatrixData((n, n), rows, cols, vals).canonical()
        if case.get("sym"):
            # 0.5 (M + M^T): SPD-ish for the CG-family solver cases
            d = MatrixData((n, n),
                           np.concatenate([d.row_idx, d.col_idx]),
                           np.concatenate([d.col_idx, d.row_idx]),
                           np.concatenate([d.values * 0.5,
                                           d.values * 0.5])).canonical()
        return d
    st = case.get("stencil", "27pt")
    size = int(case.get("size", 32))
    if st in ("5pt", "9pt"):
        return stencil_2d(size, points=int(st[0]))
    if st in ("7pt", "27pt"):
        return stencil_3d(size, points=int(st[:-2]))
    raise ValueError(f"unknown test case {case!r}")
