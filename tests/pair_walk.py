"""Kernels D and E (``ginkgo_tpu_torch/ops/csrc/pair_contract.cu``)
emulated in torch over the pair stream of ``pair_contract.pair_stream``.

The emulation follows the kernels' arithmetic: a warp owns a tile and walks
its live vregs in order, a group of 256 pairs at a time, lane l taking pairs
8 l .. 8 l + 7 of the group.  Kernel D rounds each product on its own, sums
each lane's runs of one slot in order, then sums the lanes' trailing runs
with the kernel's shuffle scan (Hillis-Steele, offsets 1 .. 16, an add only
inside the lane's run; the warp's carried run folded into lane 0 first), and
adds each run's sum to its slot where the run ends; the warp's last run is
carried into the next group and added when that group does not continue it
or the vreg ends.  A slot takes one add a vreg, in vreg order.  In f32 and
f64 this is the kernel's sum bit for bit.  Kernel E adds every product at
its slot (the kernel's atomics in the hardware's order; here in stream
order).  The COO tail (``tail``): a warp an output slot, lane l summing
the slot's pairs l, l + 32, ... in order, then a butterfly (offsets 16 ..
1), added to y.

Imports neither JAX nor ``ginkgo_tpu``: the card tests use it too."""

import torch

OW, LANES, WARP, CHUNK = 1024, 128, 32, 8
GROUP = WARP * CHUNK


def _gather(x, idx):
    """``x[idx]``, zero past the end (the plan's zero padding)."""
    ok = idx < x.shape[0]
    return torch.where(ok, x[idx.clamp(max=x.shape[0] - 1)],
                       torch.zeros((), dtype=x.dtype))


def _groups(st, a, b):
    """Per live vreg, its groups as (nvr, G, 32, 8) slots (1024 past the
    end) and products (0 where the slot is 1024), and its group count."""
    vstart = st["vstart"].cpu().long()
    size = vstart[1:] - vstart[:-1]
    nvr = size.numel()
    ngroups = -(-size // GROUP)
    G = max(1, int(ngroups.max())) if nvr else 1
    pos = torch.arange(G * GROUP)
    inside = pos[None, :] < size[:, None]
    idx = torch.where(inside, vstart[:-1, None] + pos[None, :], 0)
    if st["cl"].numel() == 0:
        inside = torch.zeros_like(inside)
        idx = torch.zeros_like(idx)
        st = dict(st, **{k: torch.zeros(1, dtype=torch.int16)
                         for k in ("cl", "cu", "co")})
    q = torch.where(inside, st["co"].cpu().long()[idx], OW)
    ia = st["va"].cpu().long()[:, None] * LANES + st["cl"].cpu().long()[idx]
    ib = st["vb"].cpu().long()[:, None] * LANES + st["cu"].cpu().long()[idx]
    p = torch.where(q < OW, _gather(a, ia) * _gather(b, ib),
                    torch.zeros((), dtype=a.dtype))
    shape = (nvr, G, WARP, CHUNK)
    return q.reshape(shape), p.reshape(shape), ngroups


def _segmented_adds(q, p, ngroups):
    """Kernel D's walk of every vreg at once: the (vreg, slot, value) adds,
    each (vreg, slot) once."""
    nvr, G = q.shape[:2]
    lane = torch.arange(WARP)
    carry = torch.zeros(nvr, dtype=p.dtype)
    carry_q = torch.full((nvr,), -1, dtype=torch.long)
    rows = torch.arange(nvr)
    adds = []

    def record(mask, slots, values):
        v = rows.view(-1, *[1] * (slots.dim() - 1)).expand_as(slots)[mask]
        adds.append((v, slots[mask], values[mask]))

    for g in range(G):
        act = g < ngroups
        qg, r = q[:, g], p[:, g].clone()
        first_head = torch.full((nvr, WARP), CHUNK, dtype=torch.long)
        for j in range(1, CHUNK):
            same = qg[..., j] == qg[..., j - 1]
            r[..., j] = torch.where(same, r[..., j - 1] + r[..., j],
                                    r[..., j])
            first_head = torch.where(~same & (first_head == CHUNK), j,
                                     first_head)
        q_in = torch.cat([carry_q[:, None], qg[:, :-1, -1]], dim=1)
        cont = qg[..., 0] == q_in
        head = (first_head < CHUNK) | ~cont
        x = r[..., -1].clone()
        x[:, 0] = torch.where(head[:, 0], x[:, 0], carry + x[:, 0])
        start = torch.where(head, lane, -1).cummax(dim=1).values
        for off in (1, 2, 4, 8, 16):
            n = torch.cat([x[:, :off], x[:, :-off]], dim=1)    # shfl_up
            ok = (lane >= off) & (lane - off >= start)
            x = torch.where(ok, x + n, x)
        c_in = torch.cat([carry[:, None], x[:, :-1]], dim=1)
        # the carried run ended at the last group's end
        flush = act & ~cont[:, 0] & (carry_q >= 0) & (carry_q < OW)
        record(flush, carry_q, carry)
        tail = torch.zeros(qg.shape, dtype=torch.bool)
        tail[..., :-1] = qg[..., :-1] != qg[..., 1:]
        tail[:, :-1, -1] = qg[:, :-1, -1] != qg[:, 1:, 0]
        tail &= (qg < OW) & act[:, None, None]
        jj = torch.arange(CHUNK)
        first = (jj[None, None, :] < first_head[..., None]) & cont[..., None]
        total = torch.where(first, c_in[..., None] + r, r)
        record(tail, qg, total)
        carry = torch.where(act, x[:, -1], carry)
        carry_q = torch.where(act, qg[:, -1, -1], carry_q)
        last = act & (g == ngroups - 1)
        record(last & (carry_q >= 0) & (carry_q < OW), carry_q, carry)
        carry_q = torch.where(last, -1, carry_q)
    v, s, val = (torch.cat(parts) for parts in zip(*adds))
    return v, s, val


def walk(a, b, st, meta_items, mode):
    """y of kernel D (``mode="cumsum_batched"``) or E (``"onehot"``) over
    the stream ``st``, COO tail not added; a, b on the CPU."""
    meta = dict(meta_items)
    T, n_out = meta["T"], meta["n_out"]
    dtype = torch.result_type(a, b)
    a, b = a.to(dtype), b.to(dtype)
    q, p, ngroups = _groups(st, a, b)
    tstart = st["tstart"].cpu().long()
    nvr = q.shape[0]
    tile = torch.repeat_interleave(torch.arange(T), tstart[1:] - tstart[:-1],
                                   output_size=nvr)
    acc = torch.zeros((T, OW), dtype=dtype)
    if mode == "onehot":
        ok = q < OW
        rows = tile[:, None, None, None].expand_as(q)
        acc.index_put_((rows[ok], q[ok]), p[ok], accumulate=True)
    elif nvr:
        v, s, val = _segmented_adds(q, p, ngroups)
        rank = (torch.arange(nvr) - tstart[tile])[v]
        for r in range(int(rank.max()) + 1 if rank.numel() else 0):
            m = rank == r
            # one add a slot a vreg; the tile's vregs in their order
            acc.index_put_((tile[v[m]], s[m]), val[m], accumulate=True)
    return acc.reshape(-1)[:n_out]


def tail(a, b, st, y):
    """``y`` plus the stream's COO tail as the kernels add it."""
    dtype = y.dtype
    a, b = a.to(dtype), b.to(dtype)
    tseg = st["tseg"].cpu().long()
    nseg = tseg.numel() - 1
    if nseg == 0:
        return y
    count = tseg[1:] - tseg[:-1]
    K = int(-(-int(count.max()) // WARP))
    k = torch.arange(K * WARP)
    inside = k[None, :] < count[:, None]
    idx = torch.where(inside, tseg[:-1, None] + k[None, :], 0)
    p = a[st["tl"].cpu().long()[idx]] * b[st["tu"].cpu().long()[idx]]
    p = torch.where(inside, p, torch.zeros((), dtype=dtype))
    p = p.reshape(nseg, K, WARP)
    v = torch.zeros((nseg, WARP), dtype=dtype)
    for j in range(K):
        v = v + p[:, j]
    lane = torch.arange(WARP)
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, lane ^ off]
    y = y.clone()
    tpo = st["tpo"].cpu().long()
    y[tpo] = y[tpo] + v[:, 0]
    return y
