"""Exact block-partitioned trisolve for UNSTRUCTURED triangular factors
(``ginkgo_tpu/ops/tri_packed.py`` in torch).

``ops/tri_banded.py`` covers factors with <=64 diagonal offsets; factors
with arbitrary in-band sparsity (ILU(0)/ParILU of an unstructured matrix)
keep the block-partitioned inverse and generalize the cross-block term to
an ELL gather from a carry window:

* rows are partitioned into S=256 blocks; within-block lower triangles
  are densified on the target device (one scatter into an
  identity-initialized (nb, S, S) slab) and inverted by the doubling
  inverse (``ops/tri_inv.batched_lowtri_inverse``);
* cross-block entries (column in one of the previous P blocks,
  P = ceil(bandwidth/S)) are packed as per-row ELL slots in
  (nb, Wv, 8, 128) tiles — four (2, 128) w-planes per tile — with int16
  indices relative to the carry window of block t, which starts at row
  (t - P) * S;
* the solve scans the blocks in order: x_t = inv_t @ (b_t - cross_t).

This module holds the host planner (verbatim from the JAX package, with
the same constants), the plain torch version ``packed_trisolve_reference``
and the wrapper of the CUDA kernel ``csrc/tri_packed.cu``, which replaces
the Pallas kernel ``ginkgo_tpu/ops/tri_packed.py::_tri_kernel``.  The bytes
it needs are the lower triangles of the (nb, S, S) f32 inverses
(~n*S/2*4 bytes), the nonzero cross slots and the vectors, but its time is
the chain of blocks: a cluster of 8 CTAs keeps the carry window on chip,
takes each block's inverse rows, cross slots and b from a ring filled
ahead of the chain, and passes right-hand-side and x slices between its
CTAs by TMA copies between their shared memories (the source says how).
Upper factors run as reversed lower systems.  f32; f64 right-hand sides
are solved in f32 and cast back, exactly the plain version's arithmetic.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.plancache import SingleSlotCache, pattern_digest
from . import _cuda
from .registry import register
from .tri_inv import batched_lowtri_inverse

_S = 256                     # rows per block (power of two)
_MAX_P = 32                  # carry window cap: P*S <= 8192 (int16 ok)
_MAX_WV = 64                 # cross ELL tiles per block (4 w-planes each)
_MAX_PLAN_BYTES = 1 << 30    # device-resident plan budget (inverse slab
                             # + cross streams); over-budget factors fall
                             # back to the level/sweep paths


def plan_packed_trisolve(data, lower: bool, unit_diagonal: bool,
                         device="cpu"):
    """Host symbolics + device build for the packed trisolve, or None
    when the factor exceeds the window/width budgets.  Returns
    (dict of tensors on ``device``, static meta).

    Split into pattern-only symbolics (cached on a pattern digest: a
    same-pattern factor with new values re-scatters and re-inverts on the
    device, skipping the host passes) and the numeric device build."""
    device = torch.device(device)
    sym = _cached_symbolics(data, lower, unit_diagonal, device)
    if sym is None:
        return None
    v = np.asarray(data.values)
    cv = v[sym["cross"]][sym["order"]].astype(np.float32)
    iv = v[sym["inb_sel"]].astype(np.float32)
    inv = _build_inverse(sym["bdest_d"], torch.from_numpy(iv).to(device),
                         nb=sym["nb"])
    crossv = torch.zeros(sym["nb"] * sym["Wv"] * 8 * 128,
                         dtype=torch.float32, device=device)
    crossv[sym["dest_d"]] = torch.from_numpy(cv).to(device)
    arrays = dict(inv=inv, crossi=sym["crossi_d"],
                  crossv=crossv.reshape(sym["nb"], sym["Wv"], 8, 128),
                  nwv=sym["nwv_d"])
    return arrays, sym["meta"]


_SYM_CACHE = SingleSlotCache()   # key: (lower, unit, dtype kind, device)


def _cached_symbolics(data, lower, unit_diagonal, device):
    dig = pattern_digest(data.row_idx, data.col_idx,
                         ints=(data.shape[0], data.nnz))
    # dtype KIND is part of the key: complex factors reject in the
    # symbolics, and a pattern-only key would let an f32 plan serve a
    # complex factor with the same pattern.  The device is part of it
    # too: the symbolics hold tensors, and a plan made for the host must
    # never hand host tensors to a solve on the card.
    key = (bool(lower), bool(unit_diagonal),
           np.dtype(data.values.dtype).kind, str(device))
    hit = _SYM_CACHE.get(key, dig)
    if hit is not _SYM_CACHE.MISS:
        return hit           # may be None: cached reject
    return _SYM_CACHE.put(
        key, dig, _trisolve_symbolics(data, lower, unit_diagonal, device))


def _trisolve_symbolics(data, lower, unit_diagonal, device):
    """Pattern-only layout planning; see plan_packed_trisolve."""
    n, m = data.shape
    if n != m or n < 2 * _S or data.nnz == 0:
        return None
    r = data.row_idx.astype(np.int64)
    c = data.col_idx.astype(np.int64)
    if np.issubdtype(data.values.dtype, np.complexfloating):
        return None             # planes would double everything; later
    if not lower:               # reversed-order rows turn U into an L
        r, c = (n - 1) - r, (n - 1) - c
    if (c > r).any():
        return None             # not triangular on the expected side
    nb = -(-n // _S)
    blk = r // _S
    cross = c < blk * _S
    bw = int((r[cross] - c[cross]).max()) if cross.any() else 1
    P = max(1, -(-bw // _S))
    if P > _MAX_P:
        return None
    # cross ELL: per-row slot ids in (row-major canonical) entry order
    cr, cc = r[cross], c[cross]
    order = np.lexsort((cc, cr))
    cr, cc = cr[order], cc[order]
    cnt = np.bincount(cr, minlength=n)
    Wmax = int(cnt.max()) if cnt.size else 0
    Wv = max(1, -(-Wmax // 4))
    if Wv > _MAX_WV:
        return None
    # device-resident storage budget: (nb, S, S) f32 inverses + the
    # int16+f32 cross streams; over budget -> None (auto-routing falls
    # back to the level/sweep solves instead of running out of memory)
    if nb * _S * _S * 4 + nb * Wv * 8 * 128 * 6 > _MAX_PLAN_BYTES:
        return None
    starts = np.zeros(n, np.int64)
    starts[1:] = np.cumsum(cnt)[:-1]
    w_of = np.arange(cr.size) - starts[cr]     # slot within the row
    s_of = cr - (cr // _S) * _S
    t_of = cr // _S
    # tile layout: plane w -> tile w//4, sub-rows (w%4)*2 + s//128
    vreg = w_of // 4
    sub = (w_of % 4) * 2 + s_of // 128
    lane = s_of % 128
    dest = ((t_of * Wv + vreg) * 8 + sub) * 128 + lane
    idx16 = (cc - (t_of - P) * _S).astype(np.int16)
    nwv = np.zeros(nb, np.int32)
    np.maximum.at(nwv, t_of, (vreg + 1).astype(np.int32))
    # in-block dense scatter targets (skip diagonal when unit)
    inb_sel = np.flatnonzero(~cross)
    ir, ic = r[inb_sel], c[inb_sel]
    if unit_diagonal:
        keep = ir != ic
        inb_sel, ir, ic = inb_sel[keep], ir[keep], ic[keep]
    ib = ir // _S
    bdest = (ib * _S + (ir - ib * _S)) * _S + (ic - ib * _S)
    dest_d = torch.from_numpy(dest).to(device)
    crossi_d = torch.zeros(nb * Wv * 8 * 128, dtype=torch.int16,
                           device=device)
    crossi_d[dest_d] = torch.from_numpy(idx16).to(device)
    meta = dict(n=int(n), nb=int(nb), P=int(P), Wv=int(Wv),
                flip=not lower, unit=bool(unit_diagonal))
    return dict(nb=int(nb), Wv=int(Wv), cross=cross, order=order,
                inb_sel=inb_sel, dest_d=dest_d,
                crossi_d=crossi_d.reshape(nb, Wv, 8, 128),
                bdest_d=torch.from_numpy(bdest).to(device),
                nwv_d=torch.from_numpy(nwv).to(device),
                meta=tuple(sorted(meta.items())))


def _build_inverse(bdest, ivals, nb):
    eye = torch.eye(_S, dtype=ivals.dtype, device=ivals.device)
    Lb = eye.expand(nb, _S, _S).reshape(-1).clone()
    Lb[bdest] = ivals
    return batched_lowtri_inverse(Lb.reshape(nb, _S, _S))


@register("packed_trisolve", "reference")
def packed_trisolve_reference(arrays, meta_items, b):
    """Plain version: the same block recurrence as a host loop over the
    blocks, all k columns at once, in f32."""
    meta = dict(meta_items)
    n, nb, P, Wv = meta["n"], meta["nb"], meta["P"], meta["Wv"]
    k = b.shape[1]
    if meta["flip"]:
        b = b.flip(0)
    bp = torch.nn.functional.pad(b.to(torch.float32),
                                 (0, 0, 0, nb * _S - n)).reshape(nb, _S, k)
    ci = arrays["crossi"].reshape(nb, Wv * 4 * 2 * 128).long()
    cvv = arrays["crossv"].reshape(nb, Wv * 4, 2, 128)
    inv = arrays["inv"]
    carry = torch.zeros((P * _S, k), dtype=torch.float32, device=b.device)
    xs = []
    for t in range(nb):
        g = carry[ci[t]].reshape(Wv * 4, 2, 128, k)
        contrib = (cvv[t][..., None] * g).sum(0).reshape(_S, k)
        x_t = inv[t] @ (bp[t] - contrib)
        carry = torch.cat([carry[_S:], x_t]) if P > 1 else x_t
        xs.append(x_t)
    x = torch.cat(xs)[:n].to(b.dtype)
    return x.flip(0) if meta["flip"] else x


@register("packed_trisolve", "cuda")
def packed_trisolve_cuda(arrays, meta_items, b):
    """Packed exact trisolve on the CUDA kernel: one launch per call (one
    cluster of 8 CTAs per group of up to 8 columns; see
    ``packed_trisolve_config``).

    A tensor on the CPU takes the plain version; on a CUDA device this
    launches the kernel or raises — it never falls back."""
    if b.device.type != "cuda":
        return packed_trisolve_reference(arrays, meta_items, b)
    meta = dict(meta_items)
    n, nb, P, Wv = meta["n"], meta["nb"], meta["P"], meta["Wv"]
    if b.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"packed_trisolve kernel takes f32 right-hand sides"
                        f" (f64 solved in f32), got {b.dtype}")
    inv, ci, cv, nwv = (arrays["inv"], arrays["crossi"], arrays["crossv"],
                        arrays["nwv"])
    if (tuple(inv.shape) != (nb, _S, _S) or inv.dtype != torch.float32
            or tuple(ci.shape) != (nb, Wv, 8, 128)
            or ci.dtype != torch.int16
            or tuple(cv.shape) != (nb, Wv, 8, 128)
            or cv.dtype != torch.float32
            or tuple(nwv.shape) != (nb,) or nwv.dtype != torch.int32
            or b.ndim != 2 or b.shape[0] != n or n > nb * _S):
        raise ValueError(
            f"packed_trisolve: inv {tuple(inv.shape)}/{inv.dtype} crossi "
            f"{tuple(ci.shape)}/{ci.dtype} crossv {tuple(cv.shape)}/"
            f"{cv.dtype} nwv {tuple(nwv.shape)}/{nwv.dtype} and b "
            f"{tuple(b.shape)} do not fit meta {meta}")
    if any(t.device != b.device for t in (inv, ci, cv, nwv)):
        raise ValueError("packed_trisolve: plan and b must share one device")
    if not all(t.is_contiguous() for t in (inv, ci, cv, nwv, b)):
        raise ValueError("packed_trisolve: plan and b must be contiguous")
    if any(t.data_ptr() % 16 for t in (inv, ci, cv)):
        raise ValueError("packed_trisolve: the kernel copies the plan in "
                         "16-byte units; inv, crossi and crossv must start "
                         "on 16-byte boundaries")
    bf = b if b.dtype == torch.float32 else b.to(torch.float32)
    k = b.shape[1]
    x = torch.empty((n, k), dtype=torch.float32, device=b.device)
    if n == 0 or k == 0:
        return x.to(b.dtype)
    lib = _cuda.library("tri_packed")
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        code = lib.tri_packed_launch(
            _cuda.type_code(torch.float32), inv.data_ptr(), ci.data_ptr(),
            cv.data_ptr(), nwv.data_ptr(), nb, P, Wv, n,
            int(bool(meta["flip"])), bf.data_ptr(), k, x.data_ptr(), k, k,
            stream)
        _cuda.check("tri_packed", code)
        packed_trisolve_cuda.launches += 1
    return x if b.dtype == torch.float32 else x.to(b.dtype)


packed_trisolve_cuda.launches = 0    # kernel launches since the last reset


def packed_trisolve_config(meta_items, k, device=None):
    """What the kernel's launch for this plan and ``k`` right-hand sides
    uses on a CUDA ``device``: CTAs a cluster, right-hand sides a cluster,
    ring stages, dynamic shared memory bytes a CTA, and the device's
    limit of it."""
    meta = dict(meta_items)
    lib = _cuda.library("tri_packed")
    fn = lib.tri_packed_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        _cuda.check("tri_packed", fn(meta["P"], meta["Wv"], int(k), out))
    return dict(cluster=out[0], rhs_per_cluster=out[1], stages=out[2],
                smem_bytes=out[3], smem_limit=out[4])
