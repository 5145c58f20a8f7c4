"""Additive Schwarz preconditioner, distributed
(``ginkgo_tpu/distributed/schwarz.py`` in torch).

Analog of ``include/ginkgo/core/distributed/preconditioner/schwarz.hpp:69``:
M⁻¹ = blockdiag(solve on each part's owned diagonal block), optionally plus
the additive coarse correction P A_c⁻¹ R (``schwarz.hpp:217-227``).

Two local paths:

* default (no ``local_solver``): an exact dense solve of each part's
  owned block (``ops/gauss_jordan.dense_solve``), a unit diagonal put
  where the block has none; the blocks are made dense once, at generate.
* ``local_solver=<factory>``: the per-part operators are generated at
  BUILD time from each part's diagonal block as a ``Coo`` on the mesh's
  device (so host-symbolic factories — Ilu, Ic, Direct, trisolves —
  work), and the apply runs each part's operator on its rows of the
  vector.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.linop import LinOp
from ..matrix.coo import Coo
from ..ops.gauss_jordan import dense_solve
from .matrix import DistributedMatrix


def _local_blocks(A: DistributedMatrix):
    """(P, local, local) dense owned blocks, a unit diagonal where a
    block's is zero."""
    local = A.local_size
    blocks = []
    for p in range(A.num_parts):
        dense = Coo(row_idx=A.loc_rows[p], col_idx=A.loc_cols[p],
                    values=A.loc_vals[p], shape=(local, local),
                    nnz=A.loc_rows.shape[1]).to_dense()
        has_diag = torch.diagonal(dense) != 0
        blocks.append(dense + torch.diag(torch.where(has_diag, 0.0, 1.0)
                                         .to(dense.dtype)))
    return torch.stack(blocks)


class SchwarzOp(LinOp):
    def __init__(self, A, local_ops=(), coarse_restrict=None,
                 coarse_prolong=None, coarse_solve=None):
        self.A = A
        self.local_ops = tuple(local_ops)  # per-part solvers (build time)
        self.blocks = None if self.local_ops else _local_blocks(A)
        self.coarse_restrict = coarse_restrict  # two-level correction
        self.coarse_prolong = coarse_prolong
        self.coarse_solve = coarse_solve

    @property
    def shape(self):
        return self.A.shape

    def _apply(self, b):
        local = self.A.local_size
        if self.local_ops:
            y = torch.cat([op._apply(b[p * local:(p + 1) * local])
                           for p, op in enumerate(self.local_ops)], dim=0)
        else:
            y = torch.cat([dense_solve(blk.to(b.dtype),
                                       b[p * local:(p + 1) * local])
                           for p, blk in enumerate(self.blocks)], dim=0)
        if self.coarse_solve is not None:
            # additive two-level correction: y += P A_c^{-1} R b
            rc = self.coarse_restrict._apply(b)
            yc = self.coarse_solve._apply(rc)
            y = y + self.coarse_prolong._apply(yc)
        return y


class Schwarz:
    """Factory: ``Schwarz(local_solver=..., coarse_level=...,
    coarse_solver=...).generate(dist_A)``.

    ``local_solver``: any solver/preconditioner factory — generated per
    part at build time (host-symbolic factories like Ilu work);
    ``coarse_level``: a coarsening factory (e.g. DistributedPgm()) enabling
    the two-level additive correction;
    ``coarse_solver``: factory for the coarse system (dense inverse default).
    """

    def __init__(self, local_solver=None, coarse_level=None,
                 coarse_solver=None):
        self.local_solver = local_solver
        self.coarse_level = coarse_level
        self.coarse_solver = coarse_solver

    @classmethod
    def build(cls, **kw):
        return cls(**kw)

    def generate(self, A: DistributedMatrix) -> SchwarzOp:
        local_ops = ()
        if self.local_solver is not None:
            local = A.local_size
            ops = []
            for p in range(A.num_parts):
                keep = A.loc_rows[p] < local
                coo = Coo(row_idx=torch.where(keep, A.loc_rows[p], local)
                          .to(torch.int32),
                          col_idx=A.loc_cols[p].to(torch.int32),
                          values=torch.where(keep, A.loc_vals[p], 0),
                          shape=(local, local), nnz=int(keep.sum()))
                ops.append(self.local_solver.generate(coo))
            local_ops = tuple(ops)
        cr = cp = cs = None
        if self.coarse_level is not None:
            lvl = self.coarse_level.generate(A)
            cr, cp = lvl.restrict, lvl.prolong
            if self.coarse_solver is not None:
                cs = self.coarse_solver.generate(lvl.coarse_op)
            else:
                from ..solver.multigrid import _DenseCoarseSolver
                dense = lvl.coarse_op.to_dense()
                cs = _DenseCoarseSolver(torch.from_numpy(np.linalg.inv(
                    dense.cpu().numpy())).to(dense.device))
        return SchwarzOp(A=A, local_ops=local_ops, coarse_restrict=cr,
                         coarse_prolong=cp, coarse_solve=cs)
