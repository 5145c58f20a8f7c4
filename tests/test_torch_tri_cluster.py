"""Kernel C's cluster walk (``ops/csrc/tri_packed.cu``) emulated on the CPU.

The emulation follows the kernel step by step on the planned arrays: the
8 CTAs of a cluster each own rows 32q .. 32q+31 of every block, fill
their ring stage with the copies the kernel issues (32 whole inverse
rows, the 16-byte pieces of their rows' cross planes, their b values;
every slot is filled, else it stays NaN and would show), sum their rows'
cross terms per warp from their own carry window (block u in slot
u % (P + 1)), send their right-hand-side rows to the other CTAs,
multiply, and send their x rows into the other windows.  It is held
against the port's ``packed_trisolve_reference`` and the JAX package's on
the same plan, for lower and flipped upper factors, P > 1, n not a
multiple of 256, k in {1, 3} (k = 3 also as two clusters of at most 2
columns), and f32 and f64 right-hand sides (solved in f32 by all)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ginkgo_tpu as gt
import ginkgo_tpu_torch as gtt
from ginkgo_tpu.ops import tri_packed as jtp
from ginkgo_tpu_torch.ops import tri_packed
from ginkgo_tpu_torch.utils.generators import random_lower_factor

S, CLUSTER, ROWS, WARPS = 256, 8, 32, 8


def slice_rows(q):
    return ROWS * q + np.arange(ROWS)


def fill_stage(arrays, meta, bp, t, q, c0, K):
    """Ring stage of block t in CTA q for columns c0 .. c0+K-1, as the
    kernel's copies fill it: (inverse rows, cross values and indices
    [plane][row], b [column][row])."""
    Wv = meta["Wv"]
    inv = arrays["inv"][t].reshape(-1)
    cv_flat = arrays["crossv"].reshape(-1)
    ci_flat = arrays["crossi"].reshape(-1)
    s0 = ROWS * q
    st_inv = inv[s0 * S:(s0 + ROWS) * S].clone()     # one bulk copy
    st_cv = torch.full((4 * Wv * ROWS,), float("nan"))
    st_ci = torch.full((4 * Wv * ROWS,), -1, dtype=torch.int64)
    for c in range(48 * Wv):              # cp.async pieces of 16 bytes
        w, piece = divmod(c, 12)
        e = (((t * Wv + (w >> 2)) * 8 + (w & 3) * 2 + (s0 >> 7)) * 128
             + (s0 & 127))
        r0 = w * ROWS
        if piece < 8:
            o = 4 * piece
            st_cv[r0 + o:r0 + o + 4] = cv_flat[e + o:e + o + 4]
        else:
            o = 8 * (piece - 8)
            st_ci[r0 + o:r0 + o + 8] = ci_flat[e + o:e + o + 8].long()
    # b: 4-byte copies, zero-filled past n and past the cluster's columns
    st_b = torch.zeros((K, ROWS))
    kc = min(K, bp.shape[1] - c0)
    st_b[:kc] = bp[t * S + slice_rows(q), c0:c0 + kc].T
    return st_inv.reshape(ROWS, S), st_cv, st_ci, st_b


def emulate_cluster_kernel(arrays, meta_items, b, K=8):
    """csrc/tri_packed.cu's walk in torch (f32), one cluster a group of K
    columns; returns x with b's dtype."""
    meta = dict(meta_items)
    n, nb, P, Wv, flip = (meta[key] for key in ("n", "nb", "P", "Wv",
                                                 "flip"))
    k = b.shape[1]
    K = min(K, k)
    Pw = P + 1                            # window slots
    bf = b.to(torch.float32)
    if flip:
        bf = bf.flip(0)                   # row r of the solve is row n-1-r
    bp = torch.zeros((nb * S, k))         # rows past n: zero
    bp[:n] = bf
    x = torch.zeros((n, k), dtype=torch.float32)
    col4 = 4 * (torch.arange(S) // 4)
    lane = torch.arange(ROWS)
    for c0 in range(0, k, K):
        kc = min(K, k - c0)
        win = [torch.zeros((Pw * S, K)) for _ in range(CLUSTER)]
        for t in range(nb):
            ring = [fill_stage(arrays, meta, bp, t, q, c0, K)
                    for q in range(CLUSTER)]
            assert not any(st[1].isnan().any() or (st[2] < 0).any()
                           for st in ring)
            rhs = [torch.zeros((S, K)) for _ in range(CLUSTER)]
            base = (t + 1) % Pw
            for q, (_, cv, ci, st_b) in enumerate(ring):
                part = torch.zeros((WARPS, ROWS, K))
                for g in range(WARPS):           # planes g, g + 8, ...
                    for w in range(g, 4 * Wv, WARPS):
                        v = cv[w * ROWS + lane]
                        idx = ci[w * ROWS + lane]
                        slot = (base + (idx >> 8)) % Pw
                        part[g] += v[:, None] * win[q][slot * S
                                                       + (idx & (S - 1))]
                rows = slice_rows(q)
                for r in range(CLUSTER):         # the rhs exchange
                    rhs[r][rows] = st_b.T - part.sum(0)
            xs_all = []
            for q, (st_inv, _, _, _) in enumerate(ring):
                rows = slice_rows(q)
                assert not st_inv.isnan().any()
                # the float4s at j <= i only, as the kernel reads them
                keep = col4[None, :] <= torch.from_numpy(rows)[:, None]
                a = torch.where(keep, st_inv, torch.zeros(()))
                xs_all.append((rows, a @ rhs[q]))          # (ROWS, K)
            for rows, xs in xs_all:                       # the x exchange
                for r in range(CLUSTER):
                    win[r][(t % Pw) * S + rows] = xs
                ok = t * S + rows < n
                x[t * S + rows[ok], c0:c0 + kc] = xs[ok, :kc]
            assert all(torch.equal(win[0], w) for w in win[1:])
            assert all(torch.equal(rhs[0], r) for r in rhs[1:])
    return (x.flip(0) if flip else x).to(b.dtype)


def _jdata(d):
    return gt.MatrixData(d.shape, d.row_idx, d.col_idx, d.values)


def _factor(name, lower):
    # (n, entries a row, reach, seed, scale): P = 3 and P = 5, n % 256 != 0
    n, per, reach, seed, scale = {"p3": (1700, 7, 600, 7, 0.04),
                                  "p5": (1400, 6, 1200, 3, 0.04)}[name]
    d = random_lower_factor(n, per, reach, seed, scale)
    if not lower:
        d = gtt.MatrixData(d.shape, d.col_idx.copy(), d.row_idx.copy(),
                           d.values.copy()).canonical()
    return d


@pytest.mark.parametrize("bdtype", [np.float32, np.float64], ids=str)
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
@pytest.mark.parametrize("name", ["p3", "p5"])
def test_cluster_walk_matches_references(name, lower, k, bdtype):
    d = _factor(name, lower)
    n = d.shape[0]
    assert n % S != 0
    arrays, meta = tri_packed.plan_packed_trisolve(d, lower, False)
    assert dict(meta)["P"] == {"p3": 3, "p5": 5}[name]
    b = np.random.default_rng(k).standard_normal((n, k)).astype(bdtype)
    bt = torch.from_numpy(b)
    want = tri_packed.packed_trisolve_reference(arrays, meta, bt)
    jarrays, jmeta = jtp.plan_packed_trisolve(_jdata(d), lower, False)
    xj = np.asarray(jtp.packed_trisolve_reference(jarrays, jmeta,
                                                  jnp.asarray(b)))
    scale = float(want.abs().max())
    for K in ((8, 2) if k == 3 else (8,)):
        x = emulate_cluster_kernel(arrays, meta, bt, K=K)
        assert x.dtype == bt.dtype
        assert float((x - want).abs().max()) <= 1e-5 * scale
        assert np.abs(x.numpy() - xj).max() <= 1e-5 * np.abs(xj).max()
