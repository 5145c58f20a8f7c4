"""Sparse triangular solvers (LowerTrs / UpperTrs)
(``ginkgo_tpu/solver/triangular.py`` in torch).

Analog of ``include/ginkgo/core/solver/triangular.hpp:65,234`` /
``core/solver/{lower_trs,upper_trs}.cpp``.  The ``algorithm`` knob:

* ``level``: dependency *level sets* computed on the host at generate
  time, packed into padded per-level entry lists; the solve is a host loop
  over levels, each a small gather + ``index_add_``.
* ``jacobi`` (the syncfree/approximate analog): fixed-point sweeps
  ``x <- D^{-1}(b - (T - D) x)``.  The strictly-triangular part is
  nilpotent with index = #levels, so ``sweeps >= #levels`` is *exact*.
  Each sweep is one SpMV of the off part as a full Csr operator (banded or
  packed kernel on the card).
* ``exact``: block-partitioned-inverse solve for banded factors
  (``ops/tri_banded.py``).
* ``exact_packed``: the same for unstructured factors
  (``ops/tri_packed.py``, CUDA kernel ``ops/csrc/tri_packed.cu``); f32
  factors only.
* ``auto`` (default): the block-inverse solve when the factor is banded,
  else the packed exact solve for an f32 factor whose plan fits, else
  #levels jacobi sweeps over a fast-layout off part on the ``cuda`` tier,
  level scheduling otherwise — the JAX package's rule with ``cuda`` in the
  place of its ``tpu`` tier.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.linop import LinOp
from ..base.matrix_data import MatrixData
from ..device import resolve_device
from ..ops.registry import lookup


def compute_levels(n, row_idx, col_idx, lower: bool) -> np.ndarray:
    """Level of each row in the triangular dependency DAG (host-side).

    For a lower factor, row r depends on all cols c < r present in row r:
    level[r] = 1 + max(level[c]).  Sequential over rows but O(nnz) total.
    """
    order = np.argsort(row_idx, kind="stable")
    rows = row_idx[order]
    cols = col_idx[order]
    ptr = np.searchsorted(rows, np.arange(n + 1))
    from ..native import compute_levels_native
    native = compute_levels_native(n, ptr, cols, lower)
    if native is not None:
        return native
    level = np.zeros(n, np.int64)
    row_iter = range(n) if lower else range(n - 1, -1, -1)
    for r in row_iter:
        cs = cols[ptr[r]:ptr[r + 1]]
        deps = cs[cs < r] if lower else cs[cs > r]
        if deps.size:
            level[r] = level[deps].max() + 1
    return level


def _pack_levels(n, row_idx, col_idx, values, diag, levels):
    """Build the static padded per-level schedule of the level solve."""
    num_levels = int(levels.max()) + 1 if n else 1
    # rows per level (stable order within a level)
    order_r = np.argsort(levels, kind="stable")
    counts_r = np.bincount(levels, minlength=num_levels)
    rmax = max(1, int(counts_r.max()))
    starts_r = np.concatenate([[0], np.cumsum(counts_r)])
    lv_sorted = levels[order_r]
    pos_r = np.arange(n) - starts_r[lv_sorted]
    lv_rows = np.full((num_levels, rmax), n, np.int64)
    lv_rows[lv_sorted, pos_r] = order_r
    slot_of_row = np.zeros(max(n, 1), np.int64)
    slot_of_row[order_r] = pos_r
    # off-diagonal entries grouped by their row's level
    off = row_idx != col_idx
    er, ec, ev = row_idx[off], col_idx[off], values[off]
    elv = levels[er]
    counts_e = np.bincount(elv, minlength=num_levels)
    emax = max(1, int(counts_e.max()))
    starts_e = np.concatenate([[0], np.cumsum(counts_e)])
    order_e = np.argsort(elv, kind="stable")
    elv_s = elv[order_e]
    pos_e = np.arange(er.size) - starts_e[elv_s]
    ent_cols = np.zeros((num_levels, emax), np.int64)
    ent_vals = np.zeros((num_levels, emax), values.dtype)
    ent_slot = np.full((num_levels, emax), rmax, np.int64)  # pad -> dropped
    ent_cols[elv_s, pos_e] = ec[order_e]
    ent_vals[elv_s, pos_e] = ev[order_e]
    ent_slot[elv_s, pos_e] = slot_of_row[er[order_e]]
    return num_levels, lv_rows, ent_cols, ent_vals, ent_slot, rmax


class TriangularSolveOp(LinOp):
    """Generated triangular solve: x = T^{-1} b.  Only the chosen
    algorithm's arrays are set; the others stay None."""

    def __init__(self, inv_diag, shape, lv_rows=None, ent_cols=None,
                 ent_vals=None, ent_slot=None, off_op=None, tri_inv=None,
                 tri_ov=None, pk_arrays=None, unit_diagonal=False,
                 algorithm="auto", sweeps=0, num_levels=1, tri_meta=None):
        self.lv_rows = lv_rows      # (L, Rmax) rows per level, padded with n
        self.ent_cols = ent_cols    # (L, Emax)
        self.ent_vals = ent_vals    # (L, Emax)
        self.ent_slot = ent_slot    # (L, Emax) local row slot, pad Rmax
        self.inv_diag = inv_diag    # (n,)
        # jacobi-sweep data: strictly triangular part as a full Csr
        self.off_op = off_op
        # block-partitioned-inverse data (algorithm='exact')
        self.tri_inv = tri_inv      # (nb, S, S)
        self.tri_ov = tri_ov        # (nb, Dc, S)
        # packed exact-solve data (algorithm='exact_packed')
        self.pk_arrays = pk_arrays
        self.shape = tuple(shape)
        self.unit_diagonal = unit_diagonal
        self.algorithm = algorithm
        self.sweeps = sweeps        # 0 = exact (#levels)
        self.num_levels = num_levels
        self.tri_meta = tri_meta

    def _apply(self, b):
        if self.algorithm == "exact":
            return lookup("banded_trisolve", b.device)(
                self.tri_inv, self.tri_ov, self.tri_meta, b)
        if self.algorithm == "exact_packed":
            return lookup("packed_trisolve", b.device)(
                self.pk_arrays, self.tri_meta, b)
        if self.algorithm == "jacobi":
            return self._solve_jacobi(b)
        return self._solve_level(b)

    def _solve_level(self, b):
        n = self.shape[0]
        rmax = self.lv_rows.shape[1]
        k = b.shape[1]
        # row n is a scratch row taking the padded level slots
        x = torch.zeros((n + 1, k), dtype=b.dtype, device=b.device)
        inv_diag = self.inv_diag.to(b.dtype)
        for rows, cols, vals, slot in zip(self.lv_rows, self.ent_cols,
                                          self.ent_vals, self.ent_slot):
            contrib = torch.zeros((rmax + 1, k), dtype=b.dtype,
                                  device=b.device)
            contrib.index_add_(0, slot, vals[:, None].to(b.dtype) * x[cols])
            rc = rows.clamp(max=n - 1)
            x[rows] = (b[rc] - contrib[:rmax]) * inv_diag[rc, None]
        return x[:n]

    def _solve_jacobi(self, b):
        sweeps = self.sweeps if self.sweeps > 0 else self.num_levels
        d = self.inv_diag[:, None].to(b.dtype)
        x = d * b
        # the strictly-triangular part is a full Csr operator, so each
        # sweep is one fast-layout SpMV
        for _ in range(sweeps):
            x = d * (b - self.off_op._apply(x))
        return x


class _TrsFactory:
    def __init__(self, lower: bool, *, algorithm: str = "auto",
                 sweeps: int = 0, unit_diagonal: bool = False):
        self.lower = lower
        self.algorithm = algorithm
        self.sweeps = sweeps
        self.unit_diagonal = unit_diagonal

    def generate(self, T) -> TriangularSolveOp:
        """T: a port operator (Csr/Coo) or MatrixData holding the
        triangular factor; the solve's tensors go to T's device."""
        data = _to_matrix_data(T)
        device = resolve_device(getattr(T, "device", None))
        n = data.shape[0]
        r, c, v = data.row_idx, data.col_idx, data.values
        # diagonal
        if self.unit_diagonal:
            diag = np.ones(n, v.dtype)
        else:
            diag = np.zeros(n, v.dtype)
            on = r == c
            diag[r[on]] = v[on]
            diag[diag == 0] = 1
        # resolve 'auto' here (generate time: tier + off layout known) so
        # only the chosen algorithm's device arrays are materialized; the
        # level DAG and the strictly-triangular Csr are built lazily below
        algo = self.algorithm
        tri_kw = dict(tri_inv=None, tri_ov=None, tri_meta=None,
                      pk_arrays=None)
        if algo in ("auto", "exact"):
            # block-partitioned-inverse exact solve for banded factors;
            # 'auto' takes it whenever the plan fits, an explicit 'exact'
            # request fails loudly if it cannot
            from ..ops.tri_banded import plan_block_trisolve
            plan = plan_block_trisolve(data, self.lower,
                                       self.unit_diagonal, device=device)
            if plan is not None:
                arrays, meta = plan
                tri_kw = dict(tri_inv=arrays["inv"], tri_ov=arrays["ov"],
                              tri_meta=tuple(sorted(meta.items())),
                              pk_arrays=None)
                algo = "banded"
            elif np.dtype(v.dtype) == np.float32:
                # unstructured factors: the packed exact solve, f32 only
                from ..ops.tri_packed import plan_packed_trisolve
                pk = plan_packed_trisolve(data, self.lower,
                                          self.unit_diagonal, device=device)
                if pk is not None:
                    arrays, meta = pk
                    tri_kw = dict(tri_inv=None, tri_ov=None,
                                  tri_meta=meta, pk_arrays=arrays)
                    algo = "exact_packed"
            if algo == "exact":
                raise ValueError(
                    "algorithm='exact' needs a banded (<=64 diagonal "
                    "offsets) or packed-plannable triangular factor with "
                    "block-inverse storage within budget; use 'level' "
                    "or 'jacobi' for this factor")
            if algo == "banded":
                algo = "exact"
        off_op = None
        num_levels = 1
        if algo in ("auto", "jacobi", "level"):
            levels = compute_levels(n, r, c, self.lower)
            num_levels = int(levels.max()) + 1 if n else 1
        if algo in ("auto", "jacobi"):
            off = r != c
            from ..matrix.csr import Csr
            off_op = Csr.from_data(
                MatrixData(data.shape, r[off], c[off], v[off]),
                strategy="automatical", device=device)
        if algo == "auto":
            from ..ops.registry import current_tier
            fast_off = getattr(off_op, "strategy",
                               "classical") != "classical"
            algo = ("jacobi" if (fast_off and current_tier(device) == "cuda")
                    else "level")
        lvl_arrays = {}
        if algo == "level":
            (num_levels, lv_rows, ent_cols, ent_vals, ent_slot,
             _) = _pack_levels(n, r, c, v, diag, levels)
            lvl_arrays = {name: torch.from_numpy(a).to(device) for name, a in
                          (("lv_rows", lv_rows), ("ent_cols", ent_cols),
                           ("ent_vals", ent_vals), ("ent_slot", ent_slot))}
        if (self.algorithm == "level" and num_levels > 64
                and data.shape[0] >= 1 << 16):
            from ..log.logger import PERFORMANCE_FALLBACK, dispatch
            dispatch(PERFORMANCE_FALLBACK, kernel="trisolve",
                     reason=f"level-scheduled solve with {num_levels} "
                            "levels is bound by its per-level gathers; "
                            "consider algorithm='jacobi' (sweeps) or an "
                            "ISAI preconditioner")
        return TriangularSolveOp(
            **lvl_arrays, **tri_kw,
            inv_diag=torch.from_numpy(1.0 / diag).to(device),
            off_op=off_op,
            shape=data.shape, unit_diagonal=self.unit_diagonal,
            algorithm=algo, sweeps=self.sweeps,
            num_levels=num_levels)


def _to_matrix_data(T):
    if hasattr(T, "to_matrix_data"):
        return T.to_matrix_data()
    return T


class _TrsAPI:
    def __init__(self, name, lower):
        self.__name__ = self.name = name
        self.lower = lower

    def build(self, **kw) -> _TrsFactory:
        return _TrsFactory(self.lower, **kw)

    def __call__(self, **kw) -> _TrsFactory:
        return self.build(**kw)


LowerTrs = _TrsAPI("LowerTrs", lower=True)
UpperTrs = _TrsAPI("UpperTrs", lower=False)
