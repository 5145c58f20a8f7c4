"""HPCG 3.1's matrix (``GenerateProblem_ref.cpp``): the 27-point stencil on
an ``nx x ny x nz`` grid, 26 on the diagonal, -1 for every neighbour inside
the grid (Dirichlet), rows numbered with x fastest.  A frozen numpy copy,
independent of the program's own generators."""

from __future__ import annotations

import numpy as np


def generate(params: dict):
    """(shape, rows, cols, values) of the HPCG matrix; ``values`` in the
    configuration's ``dtype`` (float32 by default; -1 and 26 are exact
    in every float type)."""
    nx, ny, nz = (int(params[k]) for k in ("nx", "ny", "nz"))
    n = nx * ny * nz
    step = np.array([-1, 0, 1])

    def inside(size):
        """(size, 3): whether coordinate c + step stays in [0, size)."""
        c = np.arange(size)[:, None] + step
        return (c >= 0) & (c < size)

    # HPCG's loop order sz, sy, sx over {-1, 0, 1} gives the columns of a
    # row in increasing order: (z, y, x, sz, sy, sx) row-major is sorted
    valid = (inside(nz)[:, None, None, :, None, None]
             & inside(ny)[None, :, None, None, :, None]
             & inside(nx)[None, None, :, None, None, :]).reshape(n, 27)
    rows = np.repeat(np.arange(n, dtype=np.int32),
                     valid.sum(axis=1, dtype=np.int32))
    slot = np.broadcast_to(np.arange(27, dtype=np.int8), (n, 27))[valid]
    lin = (step[:, None, None] * nx * ny + step[None, :, None] * nx
           + step[None, None, :]).reshape(27).astype(np.int32)
    cols = rows + lin[slot]
    values = np.full(len(rows), -1, np.dtype(params.get("dtype", "float32")))
    values[slot == 13] = 26
    return (n, n), rows, cols, values
