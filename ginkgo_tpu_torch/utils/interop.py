"""Sparse-ecosystem interop: scipy.sparse and torch's sparse tensors
(``ginkgo_tpu/utils/interop.py`` in torch).

The reference's external-interfacing story is matrix assembly through
``gko::matrix_data`` / ``gko::read`` (``include/ginkgo/core/base/
matrix_data.hpp``, ``examples/external-lib-interfacing``); here the two
ecosystems are:

* **scipy.sparse** — the host assembly lingua franca.  ``from_scipy`` /
  ``to_scipy`` round-trip any scipy format through :class:`MatrixData`.
* **torch sparse tensors** — COO and CSR tensors already living on a
  device (the JAX package's BCOO/BCSR counterparts).  ``from_sparse_coo``
  / ``from_sparse_csr`` build a port operator (choosing the fast SpMV
  layout at build time, like every other constructor);
  ``to_sparse_coo`` / ``to_sparse_csr`` export back.

Construction is host-symbolic by design: device inputs are pulled once,
canonicalized, and re-uploaded in the chosen layout.  Hybrid
(``dense_dim`` > 0) and batched sparse tensors have no 2-D-operator
analog and raise :class:`NotSupportedError`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.exceptions import NotSupportedError
from ..base.matrix_data import MatrixData
from ..device import resolve_device
from ..matrix.csr import _values_numpy

__all__ = ["from_scipy", "to_scipy", "from_sparse_coo", "to_sparse_coo",
           "from_sparse_csr", "to_sparse_csr"]


def _data_of(op) -> MatrixData:
    """Canonical (row-major sorted, duplicate-free) data of an export source.

    Formats like Coo expose ``to_matrix_data`` in *stored* order, which may
    be unsorted or contain duplicates; the exporters below mark their
    output coalesced and compute ``row_ptrs``, both of which require
    canonical order.  ``sum_duplicates`` is a cheap one-pass no-op for
    already-canonical data and, unlike ``canonical()``, keeps explicit
    zeros (pattern entries survive the round-trip)."""
    if isinstance(op, MatrixData):
        return op.sum_duplicates()
    return op.to_matrix_data().sum_duplicates()


def _export_device(op, device):
    """An operator's export stays on its device; MatrixData goes to
    ``device`` (``None``: the CUDA device)."""
    if device is None and not isinstance(op, MatrixData):
        return op.device
    return resolve_device(device)


def from_scipy(m, cls=None, **kwargs):
    """Build a port operator from any scipy.sparse matrix/array.

    Duplicate entries are summed (scipy COO semantics); explicit zeros
    are dropped (``Csr.from_data`` canonicalizes, which includes
    ``remove_zeros`` — matching the reference's read path).  ``cls``
    picks the target format (default :class:`~ginkgo_tpu_torch.Csr`);
    extra kwargs reach its ``from_data`` (``strategy=...``, ``dtype=...``,
    ``device=...``).
    """
    import scipy.sparse as sp
    if not sp.issparse(m):
        raise TypeError(f"expected a scipy.sparse matrix, got {type(m)!r}")
    coo = m.tocoo()
    data = MatrixData(tuple(coo.shape), coo.row.astype(np.int64),
                      coo.col.astype(np.int64), np.asarray(coo.data))
    if cls is None:
        from ..matrix.csr import Csr as cls
    return cls.from_data(data, **kwargs)


def to_scipy(op, format: str = "csr"):
    """Export an operator (or MatrixData) as a scipy.sparse matrix."""
    import scipy.sparse as sp
    d = _data_of(op)
    out = sp.coo_matrix((d.values, (d.row_idx, d.col_idx)), shape=d.shape)
    return out.asformat(format)


def _check_unbatched(t, kind):
    dense_dim = t.dense_dim()
    if t.ndim != 2 or dense_dim:
        raise NotSupportedError(
            f"{kind} tensor of shape {tuple(t.shape)} with dense_dim="
            f"{dense_dim}: only plain 2-D sparse operators map to "
            "ginkgo_tpu_torch LinOps (use ginkgo_tpu_torch.batch for "
            "batched systems)")


def from_sparse_coo(t, cls=None, **kwargs):
    """Build an operator from a ``torch.sparse_coo`` tensor (duplicates
    summed); kwargs reach ``from_data`` (``device=None``: the card)."""
    if t.layout != torch.sparse_coo:
        raise TypeError(f"expected a sparse COO tensor, got {t.layout}")
    _check_unbatched(t, "sparse COO")
    t = t.coalesce()
    idx = t.indices().cpu().numpy()
    data = MatrixData(tuple(t.shape), idx[0].astype(np.int64),
                      idx[1].astype(np.int64),
                      _values_numpy(t.values().detach().resolve_conj()))
    if cls is None:
        from ..matrix.csr import Csr as cls
    return cls.from_data(data, **kwargs)


def from_sparse_csr(t, cls=None, **kwargs):
    """Build an operator from a ``torch.sparse_csr`` tensor."""
    if t.layout != torch.sparse_csr:
        raise TypeError(f"expected a sparse CSR tensor, got {t.layout}")
    _check_unbatched(t, "sparse CSR")
    indptr = t.crow_indices().cpu().numpy().astype(np.int64)
    rows = np.repeat(np.arange(t.shape[0], dtype=np.int64), np.diff(indptr))
    data = MatrixData(tuple(t.shape), rows,
                      t.col_indices().cpu().numpy().astype(np.int64),
                      _values_numpy(t.values().detach().resolve_conj()))
    if cls is None:
        from ..matrix.csr import Csr as cls
    return cls.from_data(data, **kwargs)


def to_sparse_coo(op, device=None):
    """Export an operator (or MatrixData) as a coalesced sparse COO
    tensor, on the operator's device (MatrixData: ``device``, the card
    by default)."""
    d = _data_of(op)
    indices = torch.from_numpy(np.stack([d.row_idx, d.col_idx]).astype(
        np.int64))
    return torch.sparse_coo_tensor(
        indices, torch.from_numpy(np.asarray(d.values)), d.shape,
        is_coalesced=True, check_invariants=True).to(
        _export_device(op, device))


def to_sparse_csr(op, device=None):
    """Export an operator (or MatrixData) as a sparse CSR tensor."""
    d = _data_of(op)
    return torch.sparse_csr_tensor(
        torch.from_numpy(d.row_ptrs().astype(np.int64)),
        torch.from_numpy(np.asarray(d.col_idx, np.int64)),
        torch.from_numpy(np.asarray(d.values)), d.shape,
        check_invariants=True).to(_export_device(op, device))
