"""Distributed (row-partitioned) matrix with halo-exchange SpMV
(``ginkgo_tpu/distributed/matrix.py`` in torch).

Analog of ``include/ginkgo/core/distributed/matrix.hpp:262`` /
``core/distributed/matrix.cpp`` (local + non-local split, compressed ghost
columns, RowGatherer halo exchange) and ``read_distributed``
(matrix.cpp:300-382, ``separate_local_nonlocal``).

The operator lives on a mesh of P parts (``distributed/mesh.py``): one
device holding every part, or W ranks (one a card) holding P/W
consecutive parts each.  Every array carries a leading axis of the parts
this process holds, every vector is the global padded ``(P * local, k)``
layout (a plain tensor on one device, a ``Shard(0)`` DTensor over ranks),
so every solver runs on a ``DistributedMatrix`` unchanged.  An SpMV is
four steps on each rank's device:

    pack:      gather each of the rank's parts' send rows
    exchange:  ``dense``: the (P/W, P, S, k) send buffer regrouped by
               destination rank and sent by one ``all_to_all_single`` of
               equal splits (recv[q, p] = send[p, q]: the reference's
               ``all_to_all``; on one device a transpose of the two part
               axes); ``neighborhood``: each shift's chunk moved by its
               shift over the part axis, within the rank where it can and
               to the one or two ranks it crosses to by
               ``batch_isend_irecv`` (the reference's ``ppermute`` ring;
               on one device a roll), the chunks concatenated in shift
               order
    local:     each part's owned block: one launch of kernel A
               (``dia_spmv``) on the part's diagonals, or of kernel B
               (``pell_spmv``) on the part's compact stream, written into
               that part's rows of the rank's output; then the
               off-layout tail
    ghost:     the non-local block on the received ghost values

The host planning (``from_data``: the local/non-local split, the send and
ghost schedules, the shift grouping, the banded acceptance rule and
``_plan_packed_locals``) is the reference's, verbatim, so the planned
arrays equal its arrays element for element.  The tail, gather and ghost
sums add each row's products in a fixed order (a padded row list summed
along its width, then one ``index_add_`` whose rows are distinct), so the
two communicators give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..base.matrix_data import MatrixData
from ..base.linop import LinOp
from ..log.profiler_hook import count, span
from ..matrix.csr import _upload, host_value_types
from ..ops.registry import lookup
from ..ops.spmv_banded import kernel_vector
from ..ops.spmv_sell import sell_from_packed
from .index_map import IndexMap
from .mesh import make_mesh, mesh_device
from .partition import Partition
from .vector import on_rows, row_parts, shard

INDEX_ARRAYS = ("loc_rows", "loc_cols", "nl_rows", "nl_ghost", "send_idx",
                "ghost_owner", "ghost_slot", "send_nb", "ghost_roff",
                "lt_rows", "lt_cols")
VALUE_ARRAYS = ("loc_vals", "nl_vals", "dia_vals", "lt_vals", "pell_vals")
SLAB_ARRAYS = {"pell_idx": torch.int16, "pell_qw": torch.int32,
               "pell_xbase": torch.int32}
STATIC_FIELDS = ("shape", "local_size", "num_parts", "dia_offsets",
                 "dia_meta", "pell_meta", "axis", "comm", "shifts",
                 "shift_sizes")


def _pad2(rows_of_lists, pad_value, dtype, width=None):
    w = width if width is not None else max(
        [len(r) for r in rows_of_lists] + [1])
    out = np.full((len(rows_of_lists), w), pad_value, dtype)
    for i, r in enumerate(rows_of_lists):
        out[i, :len(r)] = r
    return out


def _row_width(rows: np.ndarray, local: int) -> int:
    """The most entries a row of a padded ``(P, m)`` row array has (pad
    rows == ``local``), at least 1."""
    P = rows.shape[0]
    flat = (np.arange(P, dtype=np.int64)[:, None] * local + rows)[
        rows < local]
    return max(int(np.bincount(flat).max()) if flat.size else 1, 1)


def _row_lists(rows: np.ndarray, local: int, device, width: int):
    """The sum plan of a padded ``(P, m)`` row array (pad rows ==
    ``local``): ``dst (R,)``, the flat output row ``p * local + r`` of each
    row that has entries, and ``sel (R, width)``, the flat indices ``p *
    m + e`` of its entries in stored order, padded with ``P * m`` (a zero
    appended to the products).  ``width``: at least ``_row_width``; the
    same width sums a row's entries in the same order."""
    P, m = rows.shape
    flat = (np.arange(P, dtype=np.int64)[:, None] * local + rows).ravel()
    ent = np.flatnonzero((rows < local).ravel())
    order = np.argsort(flat[ent], kind="stable")
    ent = ent[order]
    dst, start, count = np.unique(flat[ent], return_index=True,
                                  return_counts=True)
    sel = np.full((dst.size, width), P * m, np.int64)
    sel[np.repeat(np.arange(dst.size), count),
        np.arange(ent.size) - np.repeat(start, count)] = ent
    return (torch.from_numpy(dst).to(device),
            torch.from_numpy(sel).to(device))


def _add_rows(y, plan, vals, src_idx, src):
    """y[r] += sum of ``vals[e] * src[src_idx[e]]`` over the entries ``e``
    of row r, each row summed along its padded list (``_row_lists``)."""
    dst, sel = plan
    prod = vals.reshape(-1)[:, None].to(src.dtype) * src[src_idx]
    prod = torch.cat([prod, prod.new_zeros((1, prod.shape[1]))])
    y.index_add_(0, dst, prod[sel].sum(dim=1))


def _part_offsets(P, width, device):
    """(P, 1) tensor of ``p * width``: a part's first flat index."""
    return (torch.arange(P, device=device) * width)[:, None]


class DistributedMatrix(LinOp):
    """Square row-partitioned operator; all tensors carry a leading axis
    of the parts this process holds (all P on a one-device mesh, P/W on
    each of W ranks) and live on its device."""

    def __init__(self, loc_rows, loc_cols, loc_vals, nl_rows, nl_ghost,
                 nl_vals, send_idx, ghost_owner, ghost_slot, shape,
                 local_size, num_parts, send_nb=None, ghost_roff=None,
                 dia_vals=None, lt_rows=None, lt_cols=None, lt_vals=None,
                 dia_offsets=None, dia_meta=None, pell_vals=None,
                 pell_idx=None, pell_qw=None, pell_xbase=None,
                 pell_meta=None, mesh=None, axis="rows", comm="dense",
                 shifts=(), shift_sizes=()):
        # local (owned diagonal block), local row/col ids
        self.loc_rows = loc_rows    # (P, nnzL) padded with local_size
        self.loc_cols = loc_cols    # (P, nnzL) padded with 0
        self.loc_vals = loc_vals    # (P, nnzL)
        # non-local (ghost-column block)
        self.nl_rows = nl_rows      # (P, nnzN) padded with local_size
        self.nl_ghost = nl_ghost    # (P, nnzN) ghost id, padded with 0
        self.nl_vals = nl_vals      # (P, nnzN)
        # halo schedule, dense layout (comm='dense' only)
        self.send_idx = send_idx        # (P, P, S): part p -> rows to q
        self.ghost_owner = ghost_owner  # (P, G) owning part per ghost
        self.ghost_slot = ghost_slot    # (P, G) slot in owner's list to us
        # neighbor-compressed layout (comm='neighborhood' only)
        self.send_nb = send_nb          # (P, sum_s S_s)
        self.ghost_roff = ghost_roff    # (P, G) offset into recv concat
        self.shape = tuple(shape)       # padded global (n_pad, n_pad)
        self.local_size = int(local_size)
        self.num_parts = int(num_parts)
        # banded local blocks: one shared diagonal set, (P, G, D, S, 128)
        self.dia_vals = dia_vals
        self.dia_offsets = dia_offsets
        self.dia_meta = dia_meta
        # off-layout local tail of the banded or packed layout
        self.lt_rows = lt_rows
        self.lt_cols = lt_cols
        self.lt_vals = lt_vals
        # packed local blocks: per-part slabs padded to shared Wv/XW
        self.pell_vals = pell_vals      # (P, Gs, 8*Wv, 8, 128)
        self.pell_idx = pell_idx
        self.pell_qw = pell_qw          # (P, Gs*8*Wv)
        self.pell_xbase = pell_xbase    # (P, Gs)
        self.pell_meta = pell_meta
        self.mesh = mesh
        self.axis = axis
        self.comm = comm
        self.shifts = tuple(shifts)
        self.shift_sizes = tuple(shift_sizes)
        self.parts = (range(self.num_parts) if isinstance(mesh, str)
                      else row_parts(mesh, axis))
        self._plan_apply()

    @property
    def ranked(self) -> bool:
        """The parts are spread over the ranks of a process group."""
        return not isinstance(self.mesh, str) and self.mesh.ranked

    @property
    def device(self) -> torch.device:
        return self.loc_vals.device

    @property
    def dtype(self) -> torch.dtype:
        return self.loc_vals.dtype

    def _plan_apply(self):
        """What the apply reads besides the planned arrays, derived once:
        each part's compact stream for kernel B (``sell_from_packed`` on
        the part's slab), the flat gather indices of the exchange (the
        send rows clipped to ``[0, local)`` where the reference clips
        them), and the row sum plans of the tail, gather and ghost
        blocks."""
        P, local = len(self.parts), self.local_size
        dev = self.device
        self.sells = None
        if self.pell_vals is not None:
            self.sells = tuple(sell_from_packed(
                self.pell_vals[p], self.pell_idx[p], self.pell_qw[p],
                self.pell_xbase[p], self.pell_meta) for p in range(P))
        if self.send_idx is not None:
            self.send_src = (_part_offsets(P, local, dev)[:, :, None]
                             + self.send_idx.long().clamp(0, local - 1))
        else:
            self.send_src = (_part_offsets(P, local, dev)
                             + self.send_nb.long().clamp(0, local - 1))
        G = (self.ghost_owner if self.send_idx is not None
             else self.ghost_roff).shape[1]
        self.ghost_src = (_part_offsets(P, G, dev)
                          + self.nl_ghost.long()).reshape(-1)
        rows, cols, _ = self._tail()
        self.tail_src = (_part_offsets(P, local, dev)
                         + cols.long()).reshape(-1)
        ghost_rows, tail_rows = self.nl_rows.cpu().numpy(), rows.cpu().numpy()
        widths = [_row_width(ghost_rows, local), _row_width(tail_rows, local)]
        if self.ranked:
            # every rank pads its row lists to the widest of any rank, so
            # that a row is summed as on one device, to the same bits
            widest = torch.tensor(widths, device=dev)
            dist.all_reduce(widest, op=dist.ReduceOp.MAX)
            widths = widest.tolist()
        self.ghost_sum = _row_lists(ghost_rows, local, dev, widths[0])
        self.tail_sum = _row_lists(tail_rows, local, dev, widths[1])
        self.exchange_elems = self._remote_elems()

    def _remote_elems(self) -> int:
        """Elements a vector column sends to other ranks an exchange."""
        if not self.ranked:
            return 0
        nloc = len(self.parts)
        if self.send_idx is not None:
            return nloc * (self.num_parts - nloc) * self.send_idx.shape[2]
        return sum((hi - lo) * size * (to != self.mesh.rank)
                   for s, size in zip(self.shifts, self.shift_sizes)
                   for lo, hi, _, to, _ in self._ring_pieces(s))

    def _tail(self):
        """(rows, cols, vals) summed by row after the local kernel: the
        off-layout tail, or the whole owned block on the gather path."""
        if self.dia_vals is not None or self.pell_vals is not None:
            return self.lt_rows, self.lt_cols, self.lt_vals
        return self.loc_rows, self.loc_cols, self.loc_vals

    # -- SpMV -----------------------------------------------------------------
    def exchange(self, b):
        """The ghost values ``(P', G, k)`` of this process's rows ``b`` of
        the padded vector (P' parts held here): pack, then the
        communicator's exchange (``dense``: recv[q, p] = send[p, q] of the
        (P', P, S, k) buffers; ``neighborhood``: each shift's chunk moved
        by its shift over the part axis)."""
        nloc = len(self.parts)
        parts = torch.arange(nloc, device=b.device)[:, None]
        if self.comm == "neighborhood":
            packed = b[self.send_src]                       # (P', St, k)
            offs = np.concatenate([[0], np.cumsum(self.shift_sizes)])
            chunks = self._ring([packed[:, offs[t]:offs[t + 1]]
                                 for t in range(len(self.shifts))])
            recv = (torch.cat(chunks, dim=1) if chunks
                    else b.new_zeros((nloc, 1, b.shape[1])))
            return recv[parts, self.ghost_roff.long()]
        send = b[self.send_src]                             # (P', P, S, k)
        if self.ranked:
            recv = self._all_to_all(send)
        else:
            recv = send.transpose(0, 1).contiguous()
        return recv[parts, self.ghost_owner.long(), self.ghost_slot.long()]

    def _all_to_all(self, send):
        """recv[q, p] = send[p, q] over ranks: the (P', P, S, k) buffer
        regrouped by destination rank (P' parts a rank, so every split is
        P' * P' * S * k elements), one ``all_to_all_single``, and the
        received blocks put back in source-part order."""
        W, nloc = self.mesh.world, len(self.parts)
        buf = send.transpose(0, 1).contiguous()          # (P, P', S, k)
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf)
        # out[s * P' + q, p'] came from part s * P' + p' to my part q
        rest = out.shape[2:]
        return (out.view(W, nloc, nloc, *rest).transpose(0, 1)
                .reshape(nloc, W * nloc, *rest))

    def _ring_pieces(self, shift):
        """How a shift moves this rank's chunk over ranks: (lo, hi, at,
        to, frm) pieces.  Rows ``lo:hi`` of the chunk go to rank ``to``,
        to its rows from ``at``; this rank's output rows from ``at`` come
        from rank ``frm``."""
        W, nloc, r = self.mesh.world, len(self.parts), self.mesh.rank
        a, b = divmod(shift % self.num_parts, nloc)
        pieces = [(0, nloc - b, b, (r + a) % W, (r - a) % W),
                  (nloc - b, nloc, 0, (r + a + 1) % W, (r - a - 1) % W)]
        return [p for p in pieces if p[1] > p[0]]

    def _ring(self, chunks):
        """Each chunk ``(P', S_s, k)`` moved by its shift over the global
        part axis (out[p] = chunk[p - s]): a roll on one device; over
        ranks, the pieces that stay on the rank are copied and the others
        go to the one or two ranks the shift crosses to, all shifts in
        one ``batch_isend_irecv``."""
        if not self.ranked:
            return [torch.roll(c, s, dims=0)
                    for c, s in zip(chunks, self.shifts)]
        outs, ops = [], []
        for c, s in zip(chunks, self.shifts):
            out = torch.empty_like(c)
            for lo, hi, at, to, frm in self._ring_pieces(s):
                dst = out[at:at + hi - lo]
                if to == self.mesh.rank:
                    dst.copy_(c[lo:hi])
                    continue
                ops.append(dist.P2POp(dist.isend, c[lo:hi].contiguous(), to))
                ops.append(dist.P2POp(dist.irecv, dst, frm))
            outs.append(out)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return outs

    def _apply(self, b):
        if isinstance(self.mesh, str):
            raise ValueError("a 'schedule-only' build plans the exchange and"
                             " has no device to apply it on")
        P, local = len(self.parts), self.local_size
        like = None
        if self.ranked:
            like = on_rows(b, self.mesh, self.axis)
            b = like.to_local()
        b = kernel_vector(self.dtype, b).contiguous()
        with span("dist.exchange"):
            # what this rank sends to other ranks
            count("exchange_bytes",
                  self.exchange_elems * b.element_size() * b.shape[1])
            ghost = self.exchange(b)
        y = torch.empty_like(b)
        b3, y3 = b.view(P, local, -1), y.view(P, local, -1)
        if self.dia_vals is not None:
            spmv = lookup("dia_spmv", b.device)
            meta = dict(self.dia_meta)
            for p in range(P):
                spmv(self.dia_offsets, self.dia_vals[p], meta, b3[p],
                     out=y3[p])
        elif self.sells is not None:
            spmv = lookup("pell_spmv", b.device)
            for p in range(P):
                spmv(*self.sells[p], b3[p], out=y3[p])
        else:
            y.zero_()
        _add_rows(y, self.tail_sum, self._tail()[2], self.tail_src, b)
        _add_rows(y, self.ghost_sum, self.nl_vals, self.ghost_src,
                  ghost.reshape(-1, b.shape[1]))
        return y if like is None else shard(y, self.mesh, like=like)

    def extract_diagonal(self):
        from ..matrix.diagonal import Diagonal
        local = self.local_size
        on = self.loc_rows == self.loc_cols
        idx = torch.where(on, self.loc_rows, local).long()
        diags = torch.zeros((len(self.parts), local + 1), dtype=self.dtype,
                            device=self.device)
        diags.scatter_add_(1, idx, torch.where(on, self.loc_vals, 0))
        values = diags[:, :local].reshape(-1)
        return Diagonal(shard(values, self.mesh, self.axis)
                        if self.ranked else values)

    def to_dense(self):
        """Gather to one dense padded tensor on the host (tests only)."""
        n = self.shape[0]
        local = self.local_size
        P = self.num_parts

        def host(t):
            """The whole (P, ...) array: every rank's parts, gathered."""
            mine = t.cpu().numpy()
            if not self.ranked:
                return mine
            every = [None] * self.mesh.world
            dist.all_gather_object(every, mine)
            return np.concatenate(every)

        lr, lc, lv = host(self.loc_rows), host(self.loc_cols), \
            host(self.loc_vals)
        nr, ng, nv = host(self.nl_rows), host(self.nl_ghost), \
            host(self.nl_vals)
        dense = np.zeros((n, n), lv.dtype)
        if self.send_idx is not None:
            sidx = host(self.send_idx)
            gown = host(self.ghost_owner)
            gslot = host(self.ghost_slot)

            def sources(p, gids):
                own = gown[p][gids]
                return own, sidx[own, p, gslot[p][gids]]
        else:
            # neighborhood: reconstruct (owner, src row) lazily from the
            # compressed schedule — shift segment of the recv offset
            # identifies the sending neighbor
            snb = host(self.send_nb)
            groff = host(self.ghost_roff)
            offs = np.concatenate([[0], np.cumsum(self.shift_sizes)]) \
                if self.shift_sizes else np.zeros(1, np.int64)
            shifts_arr = np.asarray(self.shifts, np.int64)

            def sources(p, gids):
                roff = groff[p][gids]
                t = np.searchsorted(offs, roff, side="right") - 1
                own = (p - shifts_arr[np.clip(t, 0, len(shifts_arr) - 1)]
                       ) % P if shifts_arr.size else np.zeros_like(roff)
                return own, snb[own, roff]
        for p in range(P):
            ok = lr[p] < local
            dense[p * local + lr[p][ok], p * local + lc[p][ok]] += lv[p][ok]
            okn = nr[p] < local
            own, src_local = sources(p, ng[p][okn])
            dense[p * local + nr[p][okn], own * local + src_local] += \
                nv[p][okn]
        return torch.from_numpy(dense)

    # -- construction (read_distributed analog) -------------------------------
    def host_plan(self):
        """(arrays, static): the planned ``(P', ...)`` arrays as numpy
        (None where the layout has none) and the ``STATIC_FIELDS``, what
        ``from_arrays`` takes.  Of a ``"schedule-only"`` build, the whole
        plan on the host, for a leader that plans once and ships each rank
        its slice (``rank_arrays``)."""
        arrays = {name: None if getattr(self, name) is None
                  else getattr(self, name).cpu().numpy()
                  for name in INDEX_ARRAYS + VALUE_ARRAYS
                  + tuple(SLAB_ARRAYS)}
        return arrays, {name: getattr(self, name) for name in STATIC_FIELDS}

    @classmethod
    def from_arrays(cls, arrays: dict, static: dict, mesh,
                    index_dtype=torch.int32, dtype=None):
        """The operator over planned arrays: ``arrays`` name -> numpy array
        (absent or None where the layout has none), ``static`` the fields
        of ``STATIC_FIELDS``; every tensor goes to the mesh's device, the
        values in ``dtype`` (default: their own).  On a mesh over ranks
        each rank takes its parts' slice of the ``(P, ...)`` arrays; an
        array whose leading axis already counts the rank's parts is taken
        as its slice (``rank_arrays``)."""
        device = mesh_device(mesh)
        P = int(static["num_parts"])
        parts = (range(P) if isinstance(mesh, str)
                 else row_parts(mesh, static.get("axis") or "rows"))
        vdtype = host_value_types(np.asarray(arrays["loc_vals"]).dtype,
                                  dtype)[0]
        kw = {name: static.get(name) for name in STATIC_FIELDS
              if static.get(name) is not None}
        types = dict.fromkeys(INDEX_ARRAYS, index_dtype)
        types.update(dict.fromkeys(VALUE_ARRAYS, vdtype), **SLAB_ARRAYS)
        for name, tdtype in types.items():
            arr = arrays.get(name)
            if arr is not None:
                # arrays read out of another framework may be read-only,
                # which torch.from_numpy does not accept
                arr = np.asarray(arr)
                if arr.shape[0] != len(parts):
                    if arr.shape[0] != P:
                        raise ValueError(
                            f"{name} has {arr.shape[0]} parts, neither the "
                            f"mesh's {P} nor this rank's {len(parts)}")
                    arr = arr[parts.start:parts.stop]
                kw[name] = _upload(arr if arr.flags.writeable
                                   else arr.copy(), device, tdtype)
        kw.setdefault("send_idx", None)
        kw.setdefault("ghost_owner", None)
        kw.setdefault("ghost_slot", None)
        return cls(mesh=mesh, **kw)

    @classmethod
    def from_data(cls, data: MatrixData, partition: Partition, mesh=None,
                  axis: str = "rows", index_dtype=torch.int32,
                  comm: str = "dense", dtype=None):
        """Plan ``data`` over ``partition`` on the host and place it on the
        mesh's device.  ``mesh`` None: a mesh of P parts on the CUDA
        device (raises when there is none); ``"schedule-only"``: the
        planned arrays on the host, for inspection, never applied.
        ``dtype``: the value type (default: the data's; bf16 is planned
        in f32)."""
        d = data.canonical()
        n, m = d.shape
        if n != m:
            raise ValueError("distributed matrices must be square")
        if partition.global_size != n:
            raise ValueError(f"partition covers {partition.global_size} rows"
                             f", matrix has {n}")
        P = partition.num_parts
        if mesh is None:
            mesh = make_mesh((P,), (axis,))
        elif not isinstance(mesh, str) and mesh.shape.get(axis) != P:
            raise ValueError(f"mesh axes {mesh.shape} have no {axis!r} axis "
                             f"of the partition's {P} parts")
        host_dtype = host_value_types(d.values.dtype, dtype)[1]
        if d.values.dtype != host_dtype:
            d = MatrixData(d.shape, d.row_idx, d.col_idx,
                           d.values.astype(host_dtype))
        arrays, static = _plan(d, partition, comm)
        out = cls.from_arrays(arrays, dict(static, axis=axis), mesh,
                              index_dtype=index_dtype, dtype=dtype)
        # generate-time host metadata (used by DistributedPgm and re-reads)
        out.host_data = d
        out.host_partition = partition
        return out


def _plan(d: MatrixData, partition: Partition, comm: str):
    """The reference's ``from_data`` planning, verbatim: (numpy arrays,
    static fields)."""
    n = d.shape[0]
    P = partition.num_parts
    local = partition.local_size
    owner_r = partition.owner_of(d.row_idx)
    owner_c = partition.owner_of(d.col_idx)
    lrow = d.row_idx - partition.ranges[owner_r]
    # split local vs non-local (separate_local_nonlocal kernel analog)
    loc_rows, loc_cols, loc_vals = [], [], []
    nl_rows, nl_ghost, nl_vals = [], [], []
    ghost_owner, ghost_slot, ghost_src = [], [], []
    vdtype = d.values.dtype
    for p in range(P):
        mine = owner_r == p
        is_local = mine & (owner_c == p)
        is_ghost = mine & (owner_c != p)
        loc_rows.append(lrow[is_local])
        loc_cols.append(d.col_idx[is_local] - partition.ranges[p])
        loc_vals.append(d.values[is_local])
        imap = IndexMap.build(partition, p, d.col_idx[is_ghost])
        nl_rows.append(lrow[is_ghost])
        # compressed ghost columns
        gpos = np.searchsorted(imap.remote_global, d.col_idx[is_ghost])
        nl_ghost.append(gpos)
        nl_vals.append(d.values[is_ghost])
        # schedule: ghost g owned by q at local row imap.remote_local[g];
        # slots are per-(owner q -> me p) positions — vectorized group-by
        # (remote_owner is sorted, ghosts of one owner stay in order)
        gown = imap.remote_owner
        starts = np.searchsorted(gown, np.arange(P + 1))
        gsl = (np.arange(imap.num_ghosts) - starts[gown]
               if imap.num_ghosts else np.zeros(0, np.int64))
        ghost_owner.append(np.asarray(gown, np.int64))
        ghost_slot.append(np.asarray(gsl, np.int64))
        ghost_src.append(np.asarray(imap.remote_local, np.int64))
    # flat send-pair table (owner q -> dest p, slot, src local row):
    # exactly the ghost lists viewed from the sender.  remote_local[g] is
    # the row owner q must send to reach dest p at slot gsl[g].
    sp_q = np.concatenate(ghost_owner) if P else np.zeros(0, np.int64)
    sp_d = np.concatenate([np.full(ghost_owner[p].size, p, np.int64)
                           for p in range(P)])
    sp_slot = np.concatenate(ghost_slot)
    sp_src = np.concatenate(ghost_src)
    # per-(q, d) traffic counts -> dense width S and per-shift sizes
    if sp_q.size:
        pk = sp_q * P + sp_d
        upk, cnt = np.unique(pk, return_counts=True)
    else:
        upk = np.zeros(0, np.int64)
        cnt = np.zeros(0, np.int64)
    S = int(cnt.max()) if cnt.size else 1
    sh_of_pair = (upk % P - upk // P) % P
    shifts = sorted(int(s) for s in np.unique(sh_of_pair))
    shift_sizes = tuple(
        int(cnt[sh_of_pair == s].max()) for s in shifts) or ()
    if comm == "auto":
        comm = ("neighborhood"
                if len(shifts) <= max(2, P // 4) else "dense")
    # build ONLY the schedule the chosen communicator needs, so the
    # operator's bytes are O(sum_s S_s) under 'neighborhood'
    so_arr = np.zeros(P, np.int64)
    off = 0
    for t, s in enumerate(shifts):
        so_arr[s] = off
        off += shift_sizes[t]
    St = max(off, 1)
    if comm == "neighborhood":
        send_nb = np.full((P, St), local, np.int64)
        if sp_q.size:
            send_nb[sp_q, so_arr[(sp_d - sp_q) % P] + sp_slot] = sp_src
        ghost_roff = [so_arr[(p - ghost_owner[p]) % P] + ghost_slot[p]
                      for p in range(P)]
        arrays = dict(send_nb=send_nb,
                      ghost_roff=_pad2(ghost_roff, 0, np.int64))
    else:
        send_idx = np.full((P, P, S), local, np.int64)
        if sp_q.size:
            send_idx[sp_q, sp_d, sp_slot] = sp_src
        arrays = dict(send_idx=send_idx,
                      ghost_owner=_pad2(ghost_owner, 0, np.int64),
                      ghost_slot=_pad2(ghost_slot, 0, np.int64))
    # banded local-block planning: one shared diagonal set for all parts;
    # acceptance mirrors the single-device automatical rule so stencil/PDE
    # partitions ride the banded kernel per part
    static = {}
    if local >= 256 and sum(a.size for a in loc_vals):
        from ..matrix.csr import (_BANDED_MAX_DIAGS, _BANDED_MIN_FILL,
                                  _TAIL_FRACTION)
        from ..ops.spmv_banded import block_diag_values, plan_banded_layout
        off_p = [c - r for r, c in zip(loc_rows, loc_cols)]
        offsets, counts = np.unique(np.concatenate(off_p),
                                    return_counts=True)
        nt = local * P
        dense_enough = counts >= 0.3 * nt
        chosen = offsets[dense_enough]
        if chosen.size > _BANDED_MAX_DIAGS:
            order = np.argsort(-counts[dense_enough])
            chosen = np.sort(chosen[order[:_BANDED_MAX_DIAGS]])
        kept = counts[np.isin(offsets, chosen)].sum()
        total = counts.sum()
        if (chosen.size
                and kept / (chosen.size * nt) >= _BANDED_MIN_FILL
                and total - kept <= max(64 * P,
                                        _TAIL_FRACTION * chosen.size
                                        * nt)):
            offsets_t = tuple(int(o) for o in chosen)
            meta = plan_banded_layout(offsets_t, local)
            dvbs, t_r, t_c, t_v = [], [], [], []
            for p in range(P):
                keep_p = np.isin(off_p[p], chosen)
                dv = np.zeros((chosen.size, local), vdtype)
                dv[np.searchsorted(chosen, off_p[p][keep_p]),
                   loc_rows[p][keep_p]] = loc_vals[p][keep_p]
                dvbs.append(block_diag_values(dv, meta))
                t_r.append(loc_rows[p][~keep_p])
                t_c.append(loc_cols[p][~keep_p])
                t_v.append(loc_vals[p][~keep_p])
            arrays.update(dia_vals=np.stack(dvbs),
                          lt_rows=_pad2(t_r, local, np.int64),
                          lt_cols=_pad2(t_c, 0, np.int64),
                          lt_vals=_pad2(t_v, 0, vdtype))
            static.update(dia_offsets=offsets_t,
                          dia_meta=tuple(sorted(meta.items())))
        if "dia_vals" not in arrays:
            packed, pell_meta = _plan_packed_locals(
                P, local, loc_rows, loc_cols, loc_vals, vdtype)
            arrays.update(packed)
            if pell_meta is not None:
                static.update(pell_meta=pell_meta)
    arrays.update(
        loc_rows=_pad2(loc_rows, local, np.int64),
        loc_cols=_pad2(loc_cols, 0, np.int64),
        loc_vals=_pad2(loc_vals, 0, vdtype),
        nl_rows=_pad2(nl_rows, local, np.int64),
        nl_ghost=_pad2(nl_ghost, 0, np.int64),
        nl_vals=_pad2(nl_vals, 0, vdtype))
    static.update(shape=(P * local, P * local), local_size=local,
                  num_parts=P, comm=comm, shifts=tuple(shifts),
                  shift_sizes=shift_sizes)
    return arrays, static


def _plan_packed_locals(P, local, loc_rows, loc_cols, loc_vals, vdtype):
    """Packed-slot layouts for every part's local block, padded to shared
    Wv/XW bounds.  A layout planned with a smaller window/vreg budget
    stays valid under larger uniform bounds: qw (window row-groups) and
    idx ((chunk&7)*128+lane) encode positions relative to the part's own
    xbase, independent of XW; extra Wv slots pad with zero values.
    Returns ({}, None) when any part rejects (acceptance mirrors the
    single-device packed rule), else (arrays, pell_meta)."""
    from ..matrix.csr import _PACKED_MAX_PAD, _PACKED_MAX_TAIL
    from ..ops.spmv_packed import plan_packed_layout

    plans = []
    total_nnz = tot_ell = tot_slots = tot_tail = 0
    for p in range(P):
        d_p = MatrixData((local, local), loc_rows[p], loc_cols[p],
                         loc_vals[p]).canonical()
        layout, tail, stats = plan_packed_layout(d_p, d_p.values)
        if layout is None:
            return {}, None
        plans.append((layout, tail, stats))
        total_nnz += d_p.nnz
        tot_ell += stats["ell_nnz"]
        tot_slots += (layout["vals"].size if layout else 0)
        tot_tail += stats["tail_nnz"]
    if (tot_ell == 0 or tot_slots / max(tot_ell, 1) > _PACKED_MAX_PAD
            or tot_tail > _PACKED_MAX_TAIL * max(total_nnz, 1)):
        return {}, None
    wv_max = max(dict(pl["meta"])["Wv"] for pl, _, _ in plans)
    xw_max = max(dict(pl["meta"])["XW"] for pl, _, _ in plans)
    xpad_max = max(dict(pl["meta"])["xpad_rows"] for pl, _, _ in plans)
    # xpad must cover xbase + XW_max reads for every part
    xpad_max = max(xpad_max,
                   max(int(pl["xbase_row"].max(initial=0))
                       for pl, _, _ in plans) + xw_max // 128)
    pv, pi, pq, pxb, t_r, t_c, t_v = [], [], [], [], [], [], []
    Gs = dict(plans[0][0]["meta"])["Gs"]
    for layout, tail, _ in plans:
        meta_p = dict(layout["meta"])
        wv_p = meta_p["Wv"]
        vals, idx, qw = layout["vals"], layout["idx"], layout["qw"]
        if wv_p < wv_max:
            # dim 1 is block-major (index = block*Wv + vreg): pad each
            # block's vreg run, not the array tail
            pad_v = ((0, 0), (0, 0), (0, wv_max - wv_p), (0, 0), (0, 0))
            vals = np.pad(vals.reshape(Gs, 8, wv_p, 8, 128),
                          pad_v).reshape(Gs, 8 * wv_max, 8, 128)
            idx = np.pad(idx.reshape(Gs, 8, wv_p, 8, 128),
                         pad_v).reshape(Gs, 8 * wv_max, 8, 128)
            qw = np.pad(qw.reshape(Gs * 8, wv_p),
                        ((0, 0), (0, wv_max - wv_p))).reshape(-1)
        pv.append(vals)
        pi.append(idx)
        pq.append(qw)
        pxb.append(layout["xbase_row"])
        t_r.append(tail[0])
        t_c.append(tail[1])
        t_v.append(tail[2])
    meta = dict(plans[0][0]["meta"])
    meta.update(Wv=wv_max, XW=xw_max, xpad_rows=xpad_max)
    return dict(
        pell_vals=np.stack(pv), pell_idx=np.stack(pi),
        pell_qw=np.stack(pq), pell_xbase=np.stack(pxb),
        lt_rows=_pad2(t_r, local, np.int64),
        lt_cols=_pad2(t_c, 0, np.int64),
        lt_vals=_pad2(t_v, 0, vdtype)), tuple(sorted(meta.items()))


def read_distributed(data: MatrixData, partition: Partition, mesh=None,
                     **kw) -> DistributedMatrix:
    """gko::experimental::distributed read_distributed analog."""
    return DistributedMatrix.from_data(data, partition, mesh, **kw)


def rank_arrays(arrays: dict, num_parts: int, world: int) -> list:
    """The planned ``(P, ...)`` arrays cut into each of ``world`` ranks'
    slices (P / world consecutive parts each), for a parent that plans
    once and ships every rank only its parts (``launch.run_ranks``'
    ``rank_args``; ``from_arrays`` takes the slice as it is)."""
    if num_parts % world:
        raise ValueError(f"{world} ranks do not divide {num_parts} parts")
    n = num_parts // world
    return [{name: None if a is None else np.ascontiguousarray(
        np.asarray(a)[r * n:(r + 1) * n]) for name, a in arrays.items()}
        for r in range(world)]


def distribute_vector(x, partition: Partition, mesh, axis: str = "rows"):
    """Natural (global_size[, k]) host vector -> the padded vector on the
    mesh: a tensor on its device, or over ranks a ``Shard(0)`` DTensor of
    which each rank holds its parts' rows."""
    xp = partition.to_padded(np.asarray(x))
    if isinstance(mesh, str) or not mesh.ranked:
        return torch.from_numpy(xp).to(mesh_device(mesh))
    parts = row_parts(mesh, axis)
    local = partition.local_size
    mine = np.ascontiguousarray(xp[parts.start * local:parts.stop * local])
    return shard(torch.from_numpy(mine).to(mesh.device), mesh, axis)
