"""SpGEMM / SpGEAM — sparse products and sums
(``ginkgo_tpu/ops/spgemm.py`` in torch).

Analog of Ginkgo's ``csr_kernels`` spgemm/spgeam family and the
``spgemm_reuse`` interface (``core/matrix/csr.cpp:50-51``,
``core/matrix/csr_lookup.hpp:26-57``).  Two-phase by construction:

* **symbolic** (host, numpy): compute the output pattern and — for the reuse
  path — the flat list of contributing (a_idx, b_idx, out_idx) triples.
* **numeric** (on the tensors' device): one gather-multiply + ``index_add_``.

One-shot ``spgemm_data(A, B)`` runs both phases; ``SpgemmReuse`` captures
the symbolics so repeated numeric products (ParILUT sweeps, PGM
re-coarsening) skip them, mirroring Ginkgo 1.11's spgemm_reuse.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.matrix_data import MatrixData
from ..device import resolve_device
from ..native import pairs_unique_native, spgemm_csr_native


def _to_scipy(d: MatrixData):
    import scipy.sparse as sp
    return sp.csr_matrix((d.values, (d.row_idx, d.col_idx)), shape=d.shape)


def _from_scipy(m) -> MatrixData:
    coo = m.tocoo()
    return MatrixData(m.shape, coo.row.astype(np.int64),
                      coo.col.astype(np.int64), coo.data)


def _csr_arrays(d: MatrixData):
    rows = d.row_idx.astype(np.int64)
    ptr = np.searchsorted(rows, np.arange(d.shape[0] + 1)).astype(np.int64)
    return ptr, d.col_idx.astype(np.int64), d.values


def spgemm_flops(a: MatrixData, b: MatrixData) -> int:
    """Contribution-pair count of A @ B (O(nnz_A) to compute)."""
    b_ptr, _, _ = _csr_arrays(b.canonical())
    k = a.canonical().col_idx
    return int((b_ptr[k + 1] - b_ptr[k]).sum())


# one-shot products above this pair count never materialize a pair
# list: the streaming native merge (O(ncols) workspace) takes over —
# the footprint answer to the reference's hash-table symbolic
# (csr_kernels.template.cpp:1247-1290)
_STREAM_FLOPS = 16_000_000
# below this many input entries the device numeric does not pay for its
# transfers
_DEVICE_MIN_NNZ = 1 << 16


def spgemm_route(a: MatrixData, b: MatrixData, device=None) -> str:
    """The numeric ``numeric="auto"`` takes: "device" on a CUDA device when
    the product is large enough to amortize the transfer
    (nnz_a + nnz_b > 65,536) but small enough that the O(flops) pair
    capture stays cheap (flops <= ``_STREAM_FLOPS``), else "host"."""
    if resolve_device(device).type != "cuda":
        return "host"
    if a.nnz + b.nnz <= _DEVICE_MIN_NNZ:
        return "host"
    return "device" if spgemm_flops(a, b) <= _STREAM_FLOPS else "host"


def spgemm_data(a: MatrixData, b: MatrixData, numeric: str = "auto",
                device=None) -> MatrixData:
    """C = A @ B on host COO data (symbolic + numeric).

    ``numeric``: "host" = streaming native Gustavson row-merge
    (O(ncols) workspace, never an O(flops) pair list; scipy SMMP
    without the native library, and for any other name); "device" =
    host symbolic (SpgemmReuse pattern capture) + ONE
    gather-multiply-``index_add_`` on ``device`` (``None``: the CUDA
    device) — the ``csr_kernels.template.cpp:2472`` spgemm analog;
    "auto" = ``spgemm_route`` on ``device``."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"spgemm dims: {a.shape} @ {b.shape}")
    if numeric == "auto":
        numeric = spgemm_route(a, b, device)
    if numeric == "host":
        ac = a.canonical()
        bc = b.canonical()
        a_ptr, a_cols, a_vals = _csr_arrays(ac)
        b_ptr, b_cols, b_vals = _csr_arrays(bc)
        nat = spgemm_csr_native(a.shape[0], b.shape[1], a_ptr, a_cols,
                                a_vals, b_ptr, b_cols, b_vals)
        if nat is not None:
            c_ptr, c_cols, c_vals = nat
            rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                             np.diff(c_ptr))
            dtype = np.result_type(ac.values.dtype, bc.values.dtype)
            keep = c_vals != 0
            return MatrixData((a.shape[0], b.shape[1]), rows[keep],
                              c_cols[keep], c_vals[keep].astype(dtype))
    if numeric == "device":
        dev = resolve_device(device)
        reuse = SpgemmReuse(a, b, device=dev)
        vals = reuse.numeric(
            torch.from_numpy(a.canonical().values).to(dev),
            torch.from_numpy(b.canonical().values).to(dev))
        out = reuse.to_matrix_data(vals)
        keep = out.values != 0
        return MatrixData(out.shape, out.row_idx[keep],
                          out.col_idx[keep], out.values[keep])
    c = _to_scipy(a.canonical()) @ _to_scipy(b.canonical())
    c.sum_duplicates()
    c.eliminate_zeros()
    return _from_scipy(c).sort_row_major()


def spgeam_data(alpha, a: MatrixData, beta, b: MatrixData) -> MatrixData:
    """C = alpha*A + beta*B (pattern union)."""
    if a.shape != b.shape:
        raise ValueError(f"spgeam dims: {a.shape} + {b.shape}")
    c = alpha * _to_scipy(a.canonical()) + beta * _to_scipy(b.canonical())
    if hasattr(c, "sum_duplicates"):
        c.sum_duplicates()
    return _from_scipy(c).sort_row_major()


def advanced_spgemm_data(alpha, a: MatrixData, b: MatrixData, beta,
                         d: MatrixData, device=None) -> MatrixData:
    """C = alpha*A@B + beta*D (Ginkgo's advanced spgemm / apply(a,b,c,d));
    the product's numeric is routed by ``device`` as in ``spgemm_data``."""
    return spgeam_data(alpha, spgemm_data(a, b, device=device), beta, d)


class SpgemmReuse:
    """Symbolic capture of C = A @ B for repeated numeric products.

    Built from the *patterns* of A and B; ``numeric(a_vals, b_vals)``
    recomputes C's values for new A/B values on the same patterns, on the
    device the captured triples live on (``device``; ``None``: the CUDA
    device).  Contribution triples: for each a-entry (i,k) and b-entry
    (k,j), C[i,j] += a*b.
    """

    def __init__(self, a: MatrixData, b: MatrixData, device=None):
        a = a.canonical()
        b = b.canonical()
        self.a_pattern = a
        self.b_pattern = b
        # group b entries by row k
        order_b = np.argsort(b.row_idx, kind="stable")
        b_rows = b.row_idx[order_b]
        ptr = np.searchsorted(b_rows, np.arange(b.shape[0] + 1))
        # for every a entry (i, k): pairs with b row k
        counts = ptr[a.col_idx + 1] - ptr[a.col_idx]
        total = int(counts.sum())
        pa = np.repeat(np.arange(a.nnz), counts)
        # b indices: for a-entry e, range ptr[k] .. ptr[k+1]
        starts = ptr[a.col_idx]
        offs = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
        pb = order_b[np.repeat(starts, counts) + offs]
        # output slots: native per-row unique (csr_lookup analog — no
        # global O(flops log flops) sort), with the sorted-key numpy
        # fallback
        out_j = b.col_idx[pb].astype(np.int64)
        # pairs are emitted a-entry-major and a is canonical, so they
        # are already grouped by output row i
        row_counts = np.zeros(a.shape[0], np.int64)
        np.add.at(row_counts, a.row_idx, counts)
        row_pair_ptr = np.concatenate(
            [[0], np.cumsum(row_counts)]).astype(np.int64)
        nat = pairs_unique_native(a.shape[0], row_pair_ptr, out_j) \
            if total else None
        if nat is not None:
            inv, self.out_rows, self.out_cols = nat
        else:
            out_i = a.row_idx[pa].astype(np.int64)
            keys = out_i * b.shape[1] + out_j
            uniq, inv = np.unique(keys, return_inverse=True)
            self.out_rows = (uniq // b.shape[1]).astype(np.int64)
            self.out_cols = (uniq % b.shape[1]).astype(np.int64)
        self.out_nnz = self.out_rows.shape[0]
        self.shape = (a.shape[0], b.shape[1])
        dev = resolve_device(device)
        self._pa = torch.from_numpy(np.asarray(pa, np.int64)).to(dev)
        self._pb = torch.from_numpy(np.asarray(pb, np.int64)).to(dev)
        self._out = torch.from_numpy(
            np.asarray(inv, np.int64).reshape(-1)).to(dev)

    def numeric(self, a_vals, b_vals):
        """C values (canonical row-major order) from A/B values on the
        captured patterns, on the triples' device."""
        prod = a_vals[self._pa] * b_vals[self._pb]
        return prod.new_zeros(self.out_nnz).index_add_(0, self._out, prod)

    def to_matrix_data(self, c_vals) -> MatrixData:
        if isinstance(c_vals, torch.Tensor):
            c_vals = c_vals.cpu().numpy()
        return MatrixData(self.shape, self.out_rows, self.out_cols,
                          np.asarray(c_vals))
