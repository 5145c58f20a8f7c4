"""Device PGM aggregation for diagonal-structured matrices
(``ginkgo_tpu/multigrid/pgm_dia.py`` in torch).

The same Luby-style matching as the host path in ``pgm.py``
(mutual-strongest pairs under a symmetric per-edge hash tiebreak, then
size-capped attachment of the leftovers), run as mask algebra on
``(num_offs, n)`` slabs on the operand's device: the strongest neighbour
is an argmax over the offset axis, the mutual check one gather.

The reference's two ``fori_loop``s are host loops of fixed trip counts
(``iters``, then ``attach_iters``) with no host read inside.  Its uint32
hash is computed in int64 masked to 32 bits after every step (torch has
no uint32 multiply or shift on every device); the key, an f32 value,
comes out bit for bit the reference's, and ``torch.argmax`` returns the
first maximum as ``jnp.argmax`` does, so ``root`` is the reference's
index for index.
"""

from __future__ import annotations

import numpy as np
import torch

from ..factorization.par_ilut_dia import _dia_slab_device, _shifted_rows
from ..utils import stagetimer

_M32 = 0xFFFFFFFF


def plan_offsets(d, cap: int = 64):
    """Symmetric off-diagonal offset set of A, or None if unstructured."""
    n, m = d.shape
    if n != m or d.nnz == 0 or n < 4:
        return None
    off = np.unique(d.col_idx.astype(np.int64) - d.row_idx)
    off = off[off != 0]
    offs = np.unique(np.concatenate([off, -off]))
    offs = offs[(offs > -n) & (offs < n)]
    if offs.size == 0 or offs.size > cap:
        return None
    return offs


def _mul32(a, m: int):
    """(a * m) mod 2^32 for int64 ``a`` in [0, 2^32): the multiplier's
    16-bit halves keep every product under 2^49."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def edge_key(W, lo, hi):
    """The tiebroken edge weight: W (1 + u01 2^-12) in f32, with u01 the
    reference's uint32 hash of the edge's (lo, hi) endpoints in [0, 1)."""
    h = _mul32(lo, 2654435761) ^ _mul32(hi, 2246822519)
    h = _mul32(h ^ (h >> 15), 0x85EBCA6B)
    u01 = (h >> 9).to(torch.float32) * (2.0 ** -23)
    return W.to(torch.float32) * (1.0 + u01 * (2.0 ** -12))


def strongest(key, Jc, mask, axis):
    """Per-vertex strongest active slot along ``axis``: (partner,
    has_partner)."""
    k2 = torch.where(mask, key, -1.0)
    s = torch.argmax(k2, dim=axis, keepdim=True)
    best = torch.gather(k2, axis, s).squeeze(axis)
    return torch.gather(Jc, axis, s).squeeze(axis), best > 0


def match_round(key, Jc, root, axis):
    """One mutual-strongest matching round over the free vertices."""
    i = torch.arange(root.shape[0], device=root.device)
    free = root < 0
    p, has = strongest(key, Jc, free.unsqueeze(axis) & free[Jc], axis)
    pp = torch.where(has, p, i)
    mutual = has & (pp[pp] == i)
    newroot = torch.where(mutual, torch.minimum(i, pp), root)
    return torch.where(free, newroot, root)


def attach_round(key, Jc, root, axis, cap):
    """Attach each unassigned vertex to its strongest assigned neighbour
    whose aggregate is still below ``cap``."""
    assigned = root >= 0
    rc = torch.where(assigned, root, 0)
    sizes = torch.zeros_like(root).index_add_(0, rc, assigned.long())
    aj = assigned[Jc]
    ok_j = aj & (sizes[torch.where(aj, root[Jc], 0)] < cap)
    p, has = strongest(key, Jc, (~assigned).unsqueeze(axis) & ok_j, axis)
    return torch.where(~assigned & has, root[p], root)


def _pgm_match_kernel(W, offs, iters, attach_iters, cap):
    """root[i] = representative fine row of i's aggregate (or i).
    ``W``: (ND, n) symmetric weights, ``offs``: (ND,) int64 offsets."""
    ND, n = W.shape
    i = torch.arange(n, device=W.device)
    J = i[None, :] + offs[:, None]                          # (ND, n)
    inb = (J >= 0) & (J < n)
    Jc = J.clamp(0, n - 1)
    key = edge_key(W, torch.minimum(i[None, :], Jc),
                   torch.maximum(i[None, :], Jc))
    key = torch.where(inb & (W > 0), key, -1.0)
    root = torch.full((n,), -1, dtype=torch.int64, device=W.device)
    for _ in range(iters):
        root = match_round(key, Jc, root, 0)
    for _ in range(attach_iters):
        root = attach_round(key, Jc, root, 0, cap)
    return torch.where(root < 0, i, root)


def _symmetrize(slab, qneg, offs):
    """0.5 * (|A| + |A|ᵀ) on the slab: row a of the transpose is row
    qneg[a] shifted by offs[a]."""
    pad = int(offs.abs().max())
    mirror = _shifted_rows(slab, torch.stack([qneg, offs], dim=1), pad)
    return 0.5 * (slab + mirror)


def aggregate_dia(d, max_iterations: int = 15, max_agg_size: int = 8,
                  device="cpu"):
    """Device PGM aggregation on ``device``; returns root-per-row (not
    renumbered, host int64) or None when the matrix is not
    diagonal-structured."""
    offs = plan_offsets(d)
    if offs is None:
        return None
    n = d.shape[0]
    # |A| off-diagonal slab, then symmetrize on the slab:
    # |Aᵀ|[i, i+o] = |A|[i+o, i] = slab[q(-o), i+o]  (a shift)
    doff = d.col_idx.astype(np.int64) - d.row_idx
    keep = doff != 0
    p = np.searchsorted(offs, doff[keep])
    absvals = np.abs(d.values[keep]).astype(np.float32)
    qneg = np.searchsorted(offs, -offs)      # exact by symmetry
    with stagetimer.stage("transfer"):
        put = stagetimer.sync([torch.from_numpy(np.ascontiguousarray(a))
                               .to(device) for a in (
                                   absvals, p, d.row_idx[keep].astype(
                                       np.int64), qneg, offs)])
    with stagetimer.stage("device"):
        slab = _dia_slab_device(*put[:3], offs.size, n)
        W = _symmetrize(slab, put[3], put[4])
        root = stagetimer.sync(_pgm_match_kernel(
            W, put[4], int(max_iterations), 4, int(max_agg_size)))
    return root.cpu().numpy()
