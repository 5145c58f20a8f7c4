"""Plain PyTorch reference of the Krylov cells: the operator as a
``torch.sparse`` CSR matrix built from the generated arrays, scalar Jacobi,
preconditioned CG and restarted GMRES(m) with CGS2, and the true residual.

It imports nothing of the program and reads none of its state.  Every
solve takes a ``precision``:

* ``float64``: the reference the program is judged against;
* ``bfloat16``: vectors and matrix stored in bf16, each product accumulated
  in f32 and rounded back (the control of a float32 CG);
* ``tf32``: float32 throughout, but the projections and the solution update
  of GMRES multiply operands rounded to TF32's 10-bit mantissa, as the
  tensor cores do with TF32 on (the control of a float32 GMRES whose
  products run with TF32 off).  The rounding is done by hand, so it reads
  the same on any device.

Both solvers stop a column when its recurrent residual norm falls to
``tol * ||b||`` and then audit it against the true residual ``b - A x``: a
column that misses is restarted from the true residual, at most
``retries`` times, after which it is reported stagnated (the semantics of
the program's criteria).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

STORAGE = {"float64": torch.float64, "tf32": torch.float32,
           "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Solve:
    """One reference solve: x (n, k) and per-column counts and flags."""

    x: torch.Tensor
    iterations: torch.Tensor     # (k,) int64
    converged: torch.Tensor      # (k,) bool
    stagnated: torch.Tensor      # (k,) bool


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest on TF32's 10 explicit mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Operator:
    """A sparse matrix from COO arrays, summed over duplicates, as CSR."""

    def __init__(self, shape, rows, cols, values, device, dtype=torch.float64):
        idx = torch.stack([torch.as_tensor(np.asarray(rows, np.int64)),
                           torch.as_tensor(np.asarray(cols, np.int64))])
        vals = torch.as_tensor(np.asarray(values)).to(dtype)
        with warnings.catch_warnings():
            # torch's notes that sparse tensors are in beta
            warnings.simplefilter("ignore", UserWarning)
            coo = torch.sparse_coo_tensor(idx.to(device), vals.to(device),
                                          size=tuple(shape)).coalesce()
            self.csr = coo.to_sparse_csr()
        self.shape = tuple(shape)
        self.dtype = dtype
        self.max_row_nnz = int(self.csr.crow_indices().diff().max())
        on_diag = coo.indices()[0] == coo.indices()[1]
        self.diagonal = torch.zeros(shape[0], dtype=dtype, device=device)
        self.diagonal.index_add_(0, coo.indices()[0][on_diag],
                                 coo.values()[on_diag])

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A x for x (n, k); in x's dtype, accumulated in the operator's."""
        return (self.csr @ x.to(self.dtype)).to(x.dtype)

    def abs_apply(self, x: torch.Tensor) -> torch.Tensor:
        """|A| x, in the operator's dtype."""
        c = self.csr
        absolute = torch.sparse_csr_tensor(
            c.crow_indices(), c.col_indices(), c.values().abs(),
            size=self.shape)
        return absolute @ x.to(self.dtype)


def true_relres(op: Operator, b: torch.Tensor, x: torch.Tensor):
    """(k,) ||b - A x|| / ||b|| per column, in float64 (``op`` in f64)."""
    b64, x64 = b.to(torch.float64), x.to(torch.float64)
    r = b64 - op.apply(x64)
    return (torch.linalg.vector_norm(r, dim=0)
            / torch.linalg.vector_norm(b64, dim=0))


def _norm(v):
    return torch.linalg.vector_norm(v, dim=0).to(torch.float64)


def _safe_div(num, den):
    return torch.where(den == 0, torch.zeros_like(num),
                       num / torch.where(den == 0, torch.ones_like(den), den))


def cg(op: Operator, b, *, tol, max_iters, jacobi=True, retries=2,
       precision="float64", snapshot=None) -> Solve:
    """Preconditioned CG on the columns of b (n, k), x0 = 0, in Ginkgo's
    update order: z = M r, rho = <r, z>, p = z + rho / rho_prev p, q = A p,
    x += rho / <p, q> p, r -= rho / <p, q> q.

    With ``snapshot`` ((k,) iteration counts) the solve follows each column
    until it has passed both its snapshot and its own stop, without the
    audit: ``x`` is then each column's iterate at its snapshot, and
    ``iterations`` where the stop fired."""
    dtype = STORAGE[precision]
    b = b.to(dtype)
    k = b.shape[1]
    dinv = (1.0 / op.diagonal).to(dtype)[:, None] if jacobi else None

    def precond(r):
        return dinv * r if jacobi else r

    def restart(x):
        r = b - op.apply(x)
        return r, torch.zeros_like(r), (r * precond(r)).sum(0)

    x = torch.zeros_like(b)
    thresh = tol * _norm(b)
    r, p, rho = restart(x)
    iters = torch.zeros(k, dtype=torch.int64, device=b.device)
    converged = _norm(r) <= thresh
    active = ~converged
    stagnated = torch.zeros_like(converged)
    follow = snapshot is not None
    if follow:
        snapshot = torch.as_tensor(snapshot, device=b.device)
        steps = torch.zeros_like(iters)
        snap = torch.zeros_like(b)
        need = snapshot > 0
    else:
        need = torch.zeros_like(active)
    it, audits = 0, 0
    while True:
        while it < max_iters and bool((active | need).any()):
            run = active | need
            z = precond(r)
            rho_new = (r * z).sum(0)
            p_new = z + _safe_div(rho_new, rho) * p
            q = op.apply(p_new)
            alpha = _safe_div(rho_new, (p_new * q).sum(0))
            m = run[None, :]
            x = torch.where(m, x + alpha * p_new, x)
            r = torch.where(m, r - alpha * q, r)
            p = torch.where(m, p_new, p)
            rho = torch.where(run, rho_new, rho)
            iters += active
            it += 1
            stop = _norm(r) <= thresh
            converged |= active & stop
            active &= ~stop
            if follow:
                steps += run
                hit = need & (steps == snapshot)
                snap = torch.where(hit[None, :], x, snap)
                need &= ~hit
        if follow:
            return Solve(snap, iters, converged, stagnated)
        r_true, p0, rho0 = restart(x)
        bogus = converged & (_norm(r_true) > thresh)
        converged &= ~bogus
        if audits >= retries:
            stagnated |= bogus
            break
        if it >= max_iters or not bool(bogus.any()):
            break
        m = bogus[None, :]
        r = torch.where(m, r_true, r)
        p = torch.where(m, p0, p)
        rho = torch.where(bogus, rho0, rho)
        active = bogus
        audits += 1
    return Solve(x, iters, converged, stagnated)


def gmres(op: Operator, b, *, tol, max_iters, krylov_dim, retries=2,
          precision="float64", snapshot=None) -> Solve:
    """Restarted GMRES(krylov_dim) with CGS2, unpreconditioned, x0 = 0,
    column by column; ``snapshot`` as in :func:`cg`."""
    outs = [_gmres1(op, b[:, c], tol=tol, max_iters=max_iters,
                    m=krylov_dim, retries=retries, precision=precision,
                    snapshot=None if snapshot is None else int(snapshot[c]))
            for c in range(b.shape[1])]
    dev = b.device
    return Solve(torch.stack([o[0] for o in outs], dim=1),
                 torch.tensor([o[1] for o in outs], device=dev),
                 torch.tensor([o[2] for o in outs], device=dev),
                 torch.tensor([o[3] for o in outs], device=dev))


def _gmres1(op, b, *, tol, max_iters, m, retries, precision, snapshot):
    """(x, iterations, converged, stagnated) of one column."""
    dtype = STORAGE[precision]
    host = np.float64 if dtype == torch.float64 else np.float32
    b = b.to(dtype)
    # TF32 rounds both operands of a product: Vr is V's rounded copy
    rnd = round_tf32 if precision == "tf32" else (lambda t: t)
    V = torch.empty((m + 1, b.shape[0]), dtype=dtype, device=b.device)
    Vr = torch.empty_like(V) if precision == "tf32" else V
    x = torch.zeros_like(b)
    thresh = tol * float(torch.linalg.vector_norm(b.double()))
    follow = snapshot is not None
    x_snap = x if snapshot == 0 else None
    stop_it = None                  # follow: where the estimate fired
    it, used, pending = 0, 0, False

    def update(x, R, g, j):
        y = np.linalg.solve(R[:j, :j].astype(np.float64),
                            g[:j].astype(np.float64))
        yt = torch.as_tensor(y, device=b.device).to(dtype)
        return x + Vr[:j].T @ rnd(yt)

    while True:
        r = b - op.apply(x[:, None])[:, 0]
        beta = float(torch.linalg.vector_norm(r))
        if follow:
            if stop_it is None and beta <= thresh:
                stop_it = it
            if (stop_it is not None and x_snap is not None) or \
                    it >= max_iters:
                done = stop_it is not None
                return x_snap, stop_it if done else it, done, False
        else:
            if beta <= thresh:
                return x, it, True, False
            if pending:
                if used >= retries:
                    return x, it, False, True
                used += 1
            if it >= max_iters:
                return x, it, False, False
        V[0] = r / beta
        Vr[0] = rnd(V[0])
        g = np.zeros(m + 1, host)
        g[0] = beta
        R = np.zeros((m, m), host)
        cs, sn = np.zeros(m, host), np.zeros(m, host)
        j_done, pending = 0, False
        for j in range(m):
            if it >= max_iters:
                break
            w = op.apply(V[j][:, None])[:, 0]
            Vj = Vr[: j + 1]
            h = torch.zeros(j + 1, dtype=dtype, device=b.device)
            for _ in range(2):
                hp = Vj @ rnd(w)
                w = w - Vj.T @ rnd(hp)
                h = h + hp
            hn = float(torch.linalg.vector_norm(w))
            V[j + 1] = w / hn if hn != 0 else 0
            Vr[j + 1] = rnd(V[j + 1])
            col = h.double().cpu().numpy().astype(host)
            for i in range(j):
                col[i], col[i + 1] = (cs[i] * col[i] + sn[i] * col[i + 1],
                                      -sn[i] * col[i] + cs[i] * col[i + 1])
            den = np.hypot(col[j], host(hn))
            cs[j], sn[j] = (1, 0) if den == 0 else (col[j] / den, hn / den)
            R[: j + 1, j] = col[: j + 1]
            R[j, j] = den
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            it += 1
            j_done = j + 1
            fired = abs(g[j + 1]) <= thresh
            if not follow:
                if fired:
                    pending = True
                    break
                continue
            if fired and stop_it is None:
                stop_it = it
            if it == snapshot:
                x_snap = update(x, R, g, j_done)
            if stop_it is not None and x_snap is not None:
                break
        x = update(x, R, g, j_done)


def operator(matrix, device, precision="float64") -> Operator:
    """The reference operator of generated ``(shape, rows, cols, values)``;
    a bf16 solve reads an f32 operator and rounds each product."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    return Operator(*matrix, device=device, dtype=dtype)


def solve(op: Operator, b, config: dict, precision, snapshot=None) -> Solve:
    """The configuration's solver on b, as the program is asked to run it."""
    kw = dict(tol=config["tol"], max_iters=config["max_iters"],
              precision=precision, snapshot=snapshot)
    if config["solver"] == "cg":
        return cg(op, b, jacobi=config.get("preconditioner") == "jacobi",
                  **kw)
    if config["solver"] == "gmres":
        if config.get("preconditioner") or config["ortho"] != "cgs2" or \
                config["storage"] != "keep":
            raise ValueError("the GMRES reference is unpreconditioned CGS2 "
                             "with a full-precision basis")
        return gmres(op, b, krylov_dim=config["krylov_dim"], **kw)
    raise ValueError(f"unknown solver {config['solver']!r}")
