"""Carry a planned matrix across from another implementation.

For this system the "weights" are the planned operator: ``csr_from_arrays``
takes the arrays and static fields of a ``Csr`` planned elsewhere (for
instance ``ginkgo_tpu``'s, read out as numpy) and returns the port's
``Csr`` holding the same layout, without planning again.  Both packages
then run on identical operators.  ``factorization_from_arrays`` does the
same for the two factors of an incomplete factorization,
``multigrid_from_arrays`` for a whole multigrid hierarchy,
``batch_from_arrays`` for a batch matrix, and
``distributed_from_arrays`` for a distributed matrix over its mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .matrix.csr import Csr

INDEX_ARRAYS = ("row_ptr", "col_idx", "row_idx", "tail_rows", "tail_cols")
VALUE_ARRAYS = ("values", "diag_values", "tail_vals")
# the packed slab, which ``Csr`` keeps on the host once it has built its
# compact stream on the device
SLAB_ARRAYS = {"pell_vals": None, "pell_idx": torch.int16,
               "pell_qw": torch.int32, "pell_xbase": torch.int32}
STATIC_FIELDS = ("shape", "nnz", "strategy", "diag_offsets", "band_meta",
                 "pell_meta")


def csr_from_arrays(arrays: dict, static: dict, device=None,
                    index_dtype=torch.int32) -> Csr:
    """``arrays``: name -> numpy array (absent or None where the layout has
    none); ``static``: the fields of ``STATIC_FIELDS``.  The tensors are
    placed on ``device`` (``None``: the CUDA device)."""
    device = resolve_device(device)
    kw = {name: static.get(name) for name in STATIC_FIELDS}
    kw["shape"] = tuple(int(s) for s in kw["shape"])

    def put(name, dtype, dev=device):
        arr = arrays.get(name)
        if arr is not None:
            # np.array copies: arrays read out of another framework are
            # often read-only, which torch.from_numpy does not accept
            kw[name] = torch.from_numpy(np.array(arr)).to(device=dev,
                                                          dtype=dtype)

    for name in INDEX_ARRAYS:
        put(name, index_dtype)
    for name in VALUE_ARRAYS:
        put(name, None)
    for name, dtype in SLAB_ARRAYS.items():
        put(name, dtype, "cpu")
    return Csr(**kw)


def factorization_from_arrays(l_factor, u_factor, symmetric=False,
                              device=None, index_dtype=torch.int32):
    """A factorization computed elsewhere, without factorizing again:
    ``l_factor`` and ``u_factor`` are each the ``(arrays, static)`` of one
    factor's Csr, as ``csr_from_arrays`` takes them; ``symmetric`` marks an
    IC pair (U = Lᴴ).  ``Ilu(factorization=F)`` / ``Ic(factorization=F)``
    accept the result as they accept a generated one."""
    from .factorization.container import Factorization
    L = csr_from_arrays(*l_factor, device=device, index_dtype=index_dtype)
    U = csr_from_arrays(*u_factor, device=device, index_dtype=index_dtype)
    return Factorization(l_factor=L, u_factor=U, symmetric=symmetric)


def multigrid_from_arrays(fine, levels, coarsest_inv, inv_diags, *,
                          cycle="v", criteria=None, device=None,
                          index_dtype=torch.int32):
    """A multigrid hierarchy generated elsewhere, without aggregating
    again: ``fine`` is the top operator's ``(arrays, static)``; each entry
    of ``levels`` a dict with ``agg`` (the aggregate id of each fine row),
    ``coarse`` (the Galerkin operator's ``(arrays, static)``) and
    ``prolong``/``restrict`` (the transfer operators' ``(arrays, static)``,
    absent or None where the level gathers and sums by ``agg``);
    ``coarsest_inv`` the coarsest level's dense inverse and ``inv_diags``
    each level's damped-Jacobi inverse diagonal, all numpy.  Returns the
    port's ``MultigridOp`` over the same operators; level l + 1's fine
    operator is level l's coarse one, as in a generated hierarchy."""
    from .multigrid.pgm import AggProlong, AggRestrict, MultigridLevel
    from .solver.multigrid import (MultigridOp, _DampedJacobiSmoother,
                                   _DenseCoarseSolver)
    device = resolve_device(device)

    def csr(pair):
        return None if pair is None else csr_from_arrays(
            *pair, device=device, index_dtype=index_dtype)

    def put(arr):
        return torch.from_numpy(np.array(arr)).to(device)

    op = csr(fine)
    out, smoothers = [], []
    for lvl, inv_diag in zip(levels, inv_diags):
        coarse = csr(lvl["coarse"])
        agg = put(np.asarray(lvl["agg"], np.int64))
        nc = coarse.shape[0]
        out.append(MultigridLevel(
            fine_op=op, coarse_op=coarse, route="carried",
            prolong=AggProlong(agg, nc, op=csr(lvl.get("prolong"))),
            restrict=AggRestrict(agg, nc, op=csr(lvl.get("restrict")))))
        smoothers.append(_DampedJacobiSmoother(put(inv_diag), op))
        op = coarse
    return MultigridOp(out, smoothers, _DenseCoarseSolver(put(coarsest_inv)),
                       criteria=criteria, cycle=cycle)


BATCH_ARRAYS = {"BatchCsr": (("row_idx", "col_idx", "row_ptr"), "values"),
                "BatchEll": (("col_idx", "row_lengths"), "values")}


def batch_from_arrays(kind: str, arrays: dict, static: dict, device=None,
                      index_dtype=torch.int32):
    """A ``BatchCsr`` or ``BatchEll`` (``kind``) stored elsewhere in the
    same layout: ``arrays`` name -> numpy array (``BatchCsr``: row_idx,
    col_idx, row_ptr, values (nb, nnz_stored); ``BatchEll``: col_idx,
    row_lengths, values (nb, n, w)), ``static`` its ``shape`` and
    ``nnz``.  The tensors are placed on ``device`` (``None``: the CUDA
    device)."""
    from . import batch
    device = resolve_device(device)
    index_names, value_name = BATCH_ARRAYS[kind]

    def put(arr, dtype=None):
        return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)

    kw = {name: put(arrays[name], index_dtype) for name in index_names}
    return getattr(batch, kind)(
        values=put(arrays[value_name]),
        shape=tuple(int(s) for s in static["shape"]),
        nnz=int(static["nnz"]), **kw)


def distributed_from_arrays(arrays: dict, static: dict, mesh=None,
                            index_dtype=torch.int32):
    """A ``DistributedMatrix`` planned elsewhere, without planning again:
    ``arrays`` its planned arrays (name -> numpy array, absent or None
    where the layout has none: ``distributed.matrix.INDEX_ARRAYS``,
    ``VALUE_ARRAYS``, ``SLAB_ARRAYS``), ``static`` its static fields
    (``STATIC_FIELDS``: shape, local_size, num_parts, dia_offsets,
    dia_meta, pell_meta, axis, comm, shifts, shift_sizes).  ``mesh``: the
    port's mesh (``None``: ``num_parts`` parts on the CUDA device)."""
    from .distributed.matrix import DistributedMatrix
    from .distributed.mesh import make_mesh
    if mesh is None:
        mesh = make_mesh((int(static["num_parts"]),),
                         (static.get("axis") or "rows",))
    return DistributedMatrix.from_arrays(arrays, static, mesh,
                                         index_dtype=index_dtype)
