"""2-D (rows x cols) block-distributed operator
(``ginkgo_tpu/distributed/matrix2d.py`` in torch).

The reference distributes matrices one way only: a 1-D row partition with
halo exchange (``core/distributed/matrix.cpp``).  The JAX package adds the
2-D decomposition: part (i, j) of a ``("rows", "cols")`` mesh owns block
A[i, j], the input vector is partitioned over the "cols" axis, each part
computes its block's partial product, and a sum over "cols" (the
reference's ``psum``) gives the row-partitioned result.  Here the parts
share the mesh's device: each block's product is one ``coo_spmv`` call and
the sum over the cols axis is a sum over the stacked partial products.

Vectors are plain (n_pad, k) padded tensors, so every solver runs through
this operator unchanged.  Requirements: square operator, the row and
column partitions with equal padded sizes (``col_partition`` otherwise
defaults to the row partition).
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.exceptions import ValueMismatch
from ..base.linop import LinOp
from ..base.matrix_data import MatrixData
from ..ops.registry import lookup
from .mesh import Mesh, mesh_device
from .partition import Partition


class DistributedMatrix2D(LinOp):
    """Block COO storage: (Pr, Pc, cap) index/value tensors, part (i, j)
    owning slice [i, j] (pad slots carry row == local_nr, dropped by the
    sum)."""

    def __init__(self, blk_rows, blk_cols, blk_vals, shape, global_shape,
                 local_nr, local_nc, mesh=None, row_partition=None,
                 col_partition=None):
        self.blk_rows = blk_rows    # (Pr, Pc, cap) int32 local row indices
        self.blk_cols = blk_cols    # (Pr, Pc, cap) int32 local col indices
        self.blk_vals = blk_vals    # (Pr, Pc, cap)
        # like the 1-D DistributedMatrix, ``shape`` is the PADDED shape the
        # vectors have (Pr*local_nr, Pc*local_nc); the original matrix
        # dimensions live in ``global_shape``
        self.shape = tuple(shape)
        self.global_shape = tuple(global_shape)
        self.local_nr = int(local_nr)
        self.local_nc = int(local_nc)
        self.mesh = mesh
        self.row_partition = row_partition
        self.col_partition = col_partition

    @property
    def grid(self):
        return self.blk_vals.shape[0], self.blk_vals.shape[1]

    @property
    def device(self) -> torch.device:
        return self.blk_vals.device

    @property
    def dtype(self) -> torch.dtype:
        return self.blk_vals.dtype

    def _apply(self, b):
        spmv = lookup("coo_spmv", b.device)
        Pr, Pc = self.grid
        nc = self.local_nc
        partial = torch.stack([torch.stack([
            spmv(self.blk_rows[i, j], self.blk_cols[i, j],
                 self.blk_vals[i, j], b[j * nc:(j + 1) * nc], self.local_nr)
            for j in range(Pc)]) for i in range(Pr)])
        # the sum over the cols axis (the reference's psum over "cols")
        return partial.sum(dim=1).reshape(Pr * self.local_nr, b.shape[1])

    def to_dense(self):
        """Gather to one dense (n, m) tensor in NATURAL (unpadded) row/col
        order — pad slots sit at the end of each part, so the natural rows
        are selected through the partitions' padded_slot maps."""
        Pr, Pc = self.grid
        n, m = self.global_shape
        br = self.blk_rows.cpu().numpy()
        bc = self.blk_cols.cpu().numpy()
        bv = self.blk_vals.cpu().numpy()
        out = np.zeros((Pr * self.local_nr, Pc * self.local_nc), bv.dtype)
        for i in range(Pr):
            for j in range(Pc):
                keep = br[i, j] < self.local_nr
                out[i * self.local_nr + br[i, j][keep],
                    j * self.local_nc + bc[i, j][keep]] += bv[i, j][keep]
        rs = self.row_partition.padded_slot(np.arange(n))
        cs = self.col_partition.padded_slot(np.arange(m))
        return torch.from_numpy(out[np.ix_(rs, cs)])

    @classmethod
    def from_data(cls, data: MatrixData, row_partition: Partition,
                  mesh: Mesh, col_partition: Partition = None,
                  dtype=None, pad_multiple: int = 8):
        """Split the COO entries into the (Pr, Pc) block grid of the mesh.

        ``mesh`` must have axes ("rows", "cols") with sizes matching the
        partitions' num_parts."""
        from ..matrix.csr import _upload, host_value_types
        if col_partition is None:
            col_partition = row_partition
        d = data.canonical()
        Pr = row_partition.num_parts
        Pc = col_partition.num_parts
        if dict(zip(mesh.axis_names, mesh.devices.shape)) != {
                "rows": Pr, "cols": Pc}:
            raise ValueMismatch(
                f"mesh axes {dict(zip(mesh.axis_names, mesh.devices.shape))}"
                f" must be {{'rows': {Pr}, 'cols': {Pc}}}")
        if (d.shape[0] == d.shape[1]
                and row_partition.padded_size != col_partition.padded_size):
            raise ValueMismatch(
                "square operator needs matching padded sizes for the row "
                f"and column partitions (got {row_partition.padded_size} vs "
                f"{col_partition.padded_size}); pick Pr/Pc so that "
                "ceil(n/Pr)*Pr == ceil(n/Pc)*Pc, e.g. powers of two")
        device = mesh_device(mesh)
        vdtype, host = host_value_types(d.values.dtype, dtype)
        vals = d.values.astype(host, copy=False)
        local_nr = row_partition.local_size
        local_nc = col_partition.local_size
        bi = row_partition.owner_of(d.row_idx)
        bj = col_partition.owner_of(d.col_idx)
        lr = d.row_idx - row_partition.ranges[bi]
        lc = d.col_idx - col_partition.ranges[bj]
        flat = bi * Pc + bj
        order = np.argsort(flat, kind="stable")
        counts = np.bincount(flat, minlength=Pr * Pc)
        cap = max(int(counts.max()), 1)
        cap = -(-cap // pad_multiple) * pad_multiple
        BR = np.full((Pr * Pc, cap), local_nr, np.int64)
        BC = np.zeros((Pr * Pc, cap), np.int64)
        BV = np.zeros((Pr * Pc, cap), vals.dtype)
        offs = np.concatenate([[0], np.cumsum(counts)])
        lr_s, lc_s, v_s = lr[order], lc[order], vals[order]
        for blk in range(Pr * Pc):
            s, e = offs[blk], offs[blk + 1]
            BR[blk, :e - s] = lr_s[s:e]
            BC[blk, :e - s] = lc_s[s:e]
            BV[blk, :e - s] = v_s[s:e]
        return cls(
            blk_rows=_upload(BR.reshape(Pr, Pc, cap), device, torch.int32),
            blk_cols=_upload(BC.reshape(Pr, Pc, cap), device, torch.int32),
            blk_vals=_upload(BV.reshape(Pr, Pc, cap), device, vdtype),
            shape=(Pr * local_nr, Pc * local_nc), global_shape=d.shape,
            local_nr=local_nr, local_nc=local_nc, mesh=mesh,
            row_partition=row_partition, col_partition=col_partition)


def read_distributed_2d(data: MatrixData, row_partition: Partition,
                        mesh: Mesh, **kw) -> DistributedMatrix2D:
    return DistributedMatrix2D.from_data(data, row_partition, mesh, **kw)


def distribute_vector_2d(x, partition: Partition, mesh: Mesh,
                         axis: str = "rows"):
    """Natural (global_size[, k]) host vector -> padded tensor on the
    mesh's device (partitioned over one mesh axis, the same for the
    other)."""
    xp = partition.to_padded(np.asarray(x))
    return torch.from_numpy(xp).to(mesh_device(mesh))
