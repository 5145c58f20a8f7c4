"""PGM coarsening for distributed operators
(``ginkgo_tpu/multigrid/distributed_pgm.py`` in torch).

Analog of the distributed PGM path (``core/multigrid/pgm.cpp`` map_to_global
/ map_col, test/mpi/multigrid/pgm.cpp): the finest level stays distributed
(its smoother and SpMV run through the halo exchange); coarse grids — small
by construction — are whole operators on the mesh's device, the standard
practice for AMG hierarchies.  Restriction gathers the padded residual
into natural row order and sums it by aggregate; prolongation scatters
back into the padded layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.linop import LinOp
from ..distributed.matrix import DistributedMatrix
from ..matrix.csr import Csr
from .pgm import MultigridLevel, Pgm, aggregate, galerkin_coarse


class _DistRestrict(LinOp):
    """r_coarse = sum of r_padded[slots] by agg."""

    def __init__(self, slots, agg, num_coarse: int, n_pad: int):
        self.slots = slots      # (n,) padded slot of natural row i
        self.agg = agg          # (n,) aggregate of natural row i
        self.num_coarse = int(num_coarse)
        self.n_pad = int(n_pad)

    @property
    def shape(self):
        return (self.num_coarse, self.n_pad)

    def _apply(self, b):
        r_nat = b[self.slots]
        out = torch.zeros((self.num_coarse, b.shape[1]), dtype=b.dtype,
                          device=b.device)
        return out.index_add_(0, self.agg, r_nat)


class _DistProlong(LinOp):
    """x_padded = scatter(x_coarse[agg], slots)."""

    def __init__(self, slots, agg, num_coarse: int, n_pad: int):
        self.slots = slots
        self.agg = agg
        self.num_coarse = int(num_coarse)
        self.n_pad = int(n_pad)

    @property
    def shape(self):
        return (self.n_pad, self.num_coarse)

    def _apply(self, b):
        out = torch.zeros((self.n_pad, b.shape[1]), dtype=b.dtype,
                          device=b.device)
        out[self.slots] = b[self.agg]
        return out


class DistributedPgm:
    """Coarsening factory usable as Multigrid's ``mg_level`` for
    DistributedMatrix systems: level 0 bridges the padded distributed
    layout to a whole coarse operator, deeper levels delegate to plain
    PGM."""

    def __init__(self, host_data=None, **pgm_params):
        self.host_data = host_data
        self.inner = Pgm(**pgm_params)
        self.pgm_params = pgm_params

    def generate(self, A) -> MultigridLevel:
        if not isinstance(A, DistributedMatrix):
            return self.inner.generate(A)
        data = self.host_data if self.host_data is not None else \
            getattr(A, "host_data", None)
        if data is None:
            raise ValueError(
                "DistributedPgm needs the host MatrixData (pass host_data= "
                "or build the matrix via read_distributed)")
        d = data.canonical()
        n = d.shape[0]
        part = getattr(A, "host_partition", None)
        if part is None:
            raise ValueError("distributed matrix lacks partition metadata")
        device = A.device
        # pgm_aggregate, with the path it took
        agg, route = aggregate(d, device=device,
                               **{k: v for k, v in self.pgm_params.items()
                                  if k in ("max_iterations",
                                           "max_unassigned_ratio",
                                           "deterministic")})
        nc = int(agg.max()) + 1 if agg.size else 1
        coarse = Csr.from_data(galerkin_coarse(d, agg, nc),
                               strategy="classical", device=device)
        slots = torch.from_numpy(part.padded_slot(np.arange(n))).to(device)
        agg_t = torch.from_numpy(np.asarray(agg, np.int64)).to(device)
        return MultigridLevel(
            fine_op=A,
            prolong=_DistProlong(slots, agg_t, nc, part.padded_size),
            restrict=_DistRestrict(slots, agg_t, nc, part.padded_size),
            coarse_op=coarse, route=route)
