"""Exact block-partitioned trisolve for banded triangular factors
(``ginkgo_tpu/ops/tri_banded.py`` in torch).

For the factors of diagonal-structured patterns (<=64 offsets) the solve
uses a *block-partitioned inverse*:

    partition rows into S-blocks;  for block i
        x_i = inv(L_ii) @ (b_i - sum_d  l_d ⊙ shift_d(carry))

where ``L_ii`` is the (S, S) within-block lower triangle (dense inverse
precomputed once at generate time) and the cross-block term is a masked
banded multiply-add over a carry window of the last ``P = ceil(bw/S)``
blocks.  The solve is a host loop of n/S steps, each one (S,S)@(S,k)
product plus one gather of the D shifted carry rows.

Upper factors are solved as reversed lower systems (rows and columns
flipped), so one code path serves LowerTrs and UpperTrs.  The JAX package
runs this as an XLA scan (no Pallas kernel), so the port keeps it plain
torch.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import register
from .tri_inv import batched_lowtri_inverse

# block inverses cost n*S*itemsize bytes of device memory; refuse plans
# beyond this
_MAX_INV_BYTES = 1 << 30
_MAX_OFFSETS = 64


def _pick_block(n: int, bw: int) -> int:
    """Block size: 256 at large n; small problems take one or two
    blocks."""
    S = 256
    while S >= 2 * max(n, 1) and S > 8:
        S //= 2
    return max(S, 8)


def _want_device_inverse(dtype, device) -> bool:
    """Build the block inverses on the card: scatter the compact (D, n)
    diagonal planes into the (nb, S, S) slab there and invert with batched
    products (``ops/tri_inv.py``).  f32 only (f64/complex keep the
    wide-precision host LAPACK build), and only for a CUDA target (on the
    host, LAPACK beats the doubling)."""
    return (torch.device(device).type == "cuda"
            and np.dtype(dtype) == np.float32)


def _build_inverse_device(dvb, offsets, nb, S, device):
    """dvb: (D, nb, S) per-offset block value planes (diag plane
    guaranteed nonzero by the caller); returns (nb, S, S) f32 inverses on
    ``device``."""
    dvb = torch.from_numpy(np.ascontiguousarray(dvb, np.float32)).to(device)
    t = torch.arange(S, device=device)
    Lb = torch.zeros((nb, S, S), dtype=torch.float32, device=device)
    for di, off in enumerate(offsets):
        off = int(off)
        if off <= -S:
            continue            # always cross-block
        rows = t[t >= -off]
        Lb[:, rows, rows + off] = dvb[di][:, rows]
    return batched_lowtri_inverse(Lb)


def plan_block_trisolve(data, lower: bool, unit_diagonal: bool,
                        S: int | None = None, unroll: int | None = None,
                        max_bytes: int = _MAX_INV_BYTES,
                        device_build: bool | None = None, device="cpu"):
    """Build the block plan from triangular MatrixData, or None when the
    factor is not banded-triangular (too many offsets / wrong side /
    inverse storage over budget).  Host symbolics (numpy); returns
    (dict(inv=, ov=) of tensors on ``device``, meta)."""
    n, m = data.shape
    if n != m or n == 0 or data.nnz == 0:
        return None
    r = data.row_idx.astype(np.int64)
    c = data.col_idx.astype(np.int64)
    v = data.values
    if not lower:               # reversed-order rows turn U into an L
        r, c = (n - 1) - r, (n - 1) - c
    d_of = c - r
    if (d_of > 0).any():        # not triangular on the expected side
        return None
    offsets = np.unique(d_of)
    if offsets.size > _MAX_OFFSETS:
        return None
    bw = int(-offsets.min()) if offsets.size else 0
    if S is None:
        S = _pick_block(n, bw)
    if n * S * v.dtype.itemsize > max_bytes:
        return None
    nb = -(-n // S)
    P = max(1, -(-bw // S))

    # (D, nb*S) per-row diagonal values (padded rows empty)
    D = offsets.size
    dv = np.zeros((D, nb * S), v.dtype)
    d_idx = np.searchsorted(offsets, d_of)
    dv[d_idx, r] = v
    if unit_diagonal:
        z = np.searchsorted(offsets, 0)
        if z < D and offsets[z] == 0:
            dv[z, :n] = 1
        else:
            offsets = np.append(offsets, 0)
            dv = np.concatenate([dv, np.zeros((1, nb * S), v.dtype)])
            dv[-1, :n] = 1
            D += 1
    # guard: structurally-missing / zero diagonals solve as 1 (matches
    # _TrsFactory's diag handling)
    z = np.searchsorted(offsets, 0)
    has_diag = z < D and offsets[z] == 0
    if not has_diag:
        offsets = np.append(offsets, 0)
        dv = np.concatenate([dv, np.zeros((1, nb * S), v.dtype)])
        z = D
        D += 1
    diag_plane = dv[z]
    diag_plane[:n][diag_plane[:n] == 0] = 1
    diag_plane[n:] = 1          # padding rows: identity

    dvb = dv.reshape(D, nb, S)
    # cross-block value planes (diag plane excluded — never cross)
    keep = [di for di, off in enumerate(offsets) if int(off) != 0]
    ov = np.ascontiguousarray(dvb[keep].transpose(1, 0, 2))  # (nb, Dc, S)
    cross_offsets = tuple(int(offsets[di]) for di in keep)
    if unroll is None:
        unroll = 8 if nb >= 128 else (4 if nb >= 16 else 1)
    meta = dict(n=n, S=S, P=P, nb=nb, offsets=cross_offsets,
                flip=not lower, unroll=int(unroll))
    ov_d = torch.from_numpy(ov).to(device)

    # device-resident build (CUDA + f32): scatter the compact (D, n)
    # planes into the slab on the card and invert there.  Non-finite
    # inverses (ill-scaled triangles) fall through to the wide-precision
    # host build, which has the per-block singular fallback and the final
    # reject.
    want_dev = (device_build if device_build is not None
                else _want_device_inverse(v.dtype, device))
    if want_dev:
        inv_d = _build_inverse_device(dvb, offsets, nb, S, device)
        if bool(torch.isfinite(inv_d).all()):
            return dict(inv=inv_d, ov=ov_d), meta

    # dense within-block lower triangles -> batched inverse (one-time),
    # built at wide precision and inverted via LAPACK ?trtri
    wide = (np.complex128 if np.issubdtype(v.dtype, np.complexfloating)
            else np.float64)
    t = np.arange(S)
    Lb = np.zeros((nb, S, S), wide)
    for di, off in enumerate(offsets):
        off = int(off)
        if off <= -S:
            continue            # always cross-block
        rows = t[t >= -off]
        Lb[:, rows, rows + off] = dvb[di][:, rows]
    from scipy.linalg import get_lapack_funcs
    (trtri,) = get_lapack_funcs(("trtri",), (Lb[0],))
    inv = np.empty((nb, S, S), v.dtype)
    with np.errstate(over="ignore", invalid="ignore"):
        for i in range(nb):
            blk, info = trtri(Lb[i], lower=1)
            if info != 0:       # singular block: fall back to LU inverse
                blk = np.linalg.inv(Lb[i])
            inv[i] = blk.astype(v.dtype)
    if not np.isfinite(inv).all():
        # an ill-scaled triangle whose block inverse exceeds the value
        # type's range: reject so algorithm='auto' falls back to the
        # inverse-free level solve instead of applying inf/nan
        return None
    return dict(inv=torch.from_numpy(inv).to(device), ov=ov_d), meta


@register("banded_trisolve", "reference")
def block_trisolve_apply(inv, ov, meta_items, b):
    """x = T^{-1} b via the block recurrence.  ``b``: (n, k)."""
    meta = dict(meta_items)
    n, S, P, nb = meta["n"], meta["S"], meta["P"], meta["nb"]
    offsets = meta["offsets"]
    k = b.shape[1]
    dev = b.device
    if meta["flip"]:
        b = b.flip(0)
    bp = torch.nn.functional.pad(b, (0, 0, 0, nb * S - n)).reshape(nb, S, k)
    PS = P * S
    s = torch.arange(S, device=dev)
    # cross term of row s over offset off reads carry row PS + off + s,
    # for the rows s < -off whose column lies in an earlier block
    offs = torch.tensor(offsets, dtype=torch.int64, device=dev).reshape(-1, 1)
    mask = s[None, :] < -offs                                  # (Dc, S)
    idx = torch.where(mask, PS + offs + s[None, :], 0).reshape(-1)
    ovm = torch.where(mask[None], ov, torch.zeros((), dtype=ov.dtype,
                                                  device=dev)).to(b.dtype)
    invb = inv.to(b.dtype)
    carry = torch.zeros((PS, k), dtype=b.dtype, device=dev)
    xs = []
    for i in range(nb):
        rhs = bp[i]
        if offsets:
            g = carry[idx].reshape(len(offsets), S, k)
            rhs = rhs - (ovm[i][:, :, None] * g).sum(0)
        x_i = invb[i] @ rhs
        carry = x_i if P == 1 else torch.cat([carry[S:], x_i])
        xs.append(x_i)
    x = torch.cat(xs)[:n]
    return x.flip(0) if meta["flip"] else x
