"""Device PGM aggregation for general unstructured matrices
(``ginkgo_tpu/multigrid/pgm_packed.py`` in torch).

The matching of ``pgm_dia.py`` over a padded ELL layout instead of
diagonal slabs: per-row neighbour lists (n, W) with a validity mask, the
strongest neighbour as a row argmax, the mutual check as one gather,
size-capped attachment of the leftovers.  The reference's ``while_loop``
(at most ``iters`` rounds, ending once no more than n // 20 vertices are
unmatched) is a host loop that reads the unmatched count once a round,
so it runs the reference's rounds.

Host cost is one scipy symmetrization + ELL padding (O(nnz log nnz));
device cost is about two gathers per edge per round.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import stagetimer
from .pgm_dia import attach_round, edge_key, match_round

_MAX_W = 64         # padded neighbors per row; weak tails truncated


def _ell_build(rows, cols, slot, vals, n, W):
    """Scatter the CSR triple into the padded (n, W) ELL layout on the
    triple's device (shipping the padded layout costs W/deg x more than
    the CSR-sized arrays)."""
    dest = rows * W + slot
    J = torch.zeros(n * W, dtype=torch.int64, device=rows.device)
    Wv = torch.zeros(n * W, dtype=torch.float32, device=rows.device)
    valid = torch.zeros(n * W, dtype=torch.bool, device=rows.device)
    J[dest] = cols
    Wv[dest] = vals
    valid[dest] = True
    return J.reshape(n, W), Wv.reshape(n, W), valid.reshape(n, W)


def _pgm_match_packed(J, Wv, valid, iters, attach_iters, cap):
    """root[i] = representative fine row of i's aggregate (or i).
    ``J``/``Wv``/``valid``: (n, W) padded neighbor columns, weights,
    slot validity."""
    n, W = J.shape
    i = torch.arange(n, device=J.device)
    Jc = J.clamp(0, n - 1)
    key = edge_key(Wv, torch.minimum(i[:, None], Jc),
                   torch.maximum(i[:, None], Jc))
    key = torch.where(valid & (Wv > 0), key, -1.0)
    root = torch.full((n,), -1, dtype=torch.int64, device=J.device)
    # early exit once <5% of vertices remain unmatched (the host path's
    # max_unassigned_ratio)
    for _ in range(iters):
        if int((root < 0).sum()) <= n // 20:
            break
        root = match_round(key, Jc, root, 1)
    for _ in range(attach_iters):
        root = attach_round(key, Jc, root, 1, cap)
    return torch.where(root < 0, i, root)


def aggregate_packed(d, max_iterations: int = 15, max_agg_size: int = 8,
                     device="cpu"):
    """Device PGM aggregation over the padded ELL neighbor layout on
    ``device``; returns root-per-row (not renumbered, host int64) or None
    when the matrix has no off-diagonal entry."""
    import scipy.sparse as sp
    n = d.shape[0]
    if n < 4 or d.nnz == 0:
        return None
    off = d.row_idx != d.col_idx
    w = sp.csr_matrix((np.abs(d.values[off]).astype(np.float64),
                       (d.row_idx[off], d.col_idx[off])), shape=(n, n))
    w = ((w + w.T) * 0.5).tocsr()
    deg = np.diff(w.indptr)
    W = int(deg.max()) if n else 0
    if W == 0:
        return None
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    data = w.data
    cols_k = w.indices
    if W > _MAX_W:
        # heavy rows (boundary clusters): keep each row's _MAX_W
        # strongest edges — matching only ever uses the strongest
        # active neighbor, so truncating the weak tail is benign
        order = np.lexsort((-np.abs(data), rows))
        rows, cols_k, data = rows[order], cols_k[order], data[order]
        # strongest-first position within each row (row grouping and
        # per-row counts are unchanged by the in-row reorder)
        slot = np.arange(w.nnz) - np.repeat(w.indptr[:-1], deg)
        keep = slot < _MAX_W
        rows, slot = rows[keep], slot[keep]
        cols_k, data = cols_k[keep], data[keep]
        W = _MAX_W
    else:
        slot = np.arange(w.nnz) - np.repeat(w.indptr[:-1], deg)
    with stagetimer.stage("transfer"):
        args = stagetimer.sync([torch.from_numpy(np.ascontiguousarray(a))
                                .to(device) for a in (
                                    rows, cols_k.astype(np.int64),
                                    slot.astype(np.int64),
                                    data.astype(np.float32))])
    with stagetimer.stage("device"):
        J, Wv, valid = _ell_build(*args, n=n, W=W)
        root = stagetimer.sync(_pgm_match_packed(
            J, Wv, valid, int(max_iterations), 4, int(max_agg_size)))
    return root.cpu().numpy()
