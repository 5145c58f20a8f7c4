"""Iterative refinement / (preconditioned) Richardson
(``ginkgo_tpu/solver/ir.py`` in torch).

Analog of ``core/solver/ir.cpp`` (``include/ginkgo/core/solver/ir.hpp:81``):
``x += relaxation_factor * solver(b - A x)`` with a pluggable inner solver
(Ginkgo's ``with_solver``; identity by default = plain Richardson).  This is
the host of the mixed-precision-IR pattern: pass an inner solver generated at
lower precision.
"""

from __future__ import annotations

import torch

from ..base.dtypes import complex_dtype, is_complex
from ..base.linop import LinOp
from ..matrix.dense import compute_norm2
from ..stop.criterion import CheckArgs, default_criterion
from .common import (SolverAPI, finish, prepare_rhs, resolve_precond,
                     run_iteration_loop)


def _value_dtype(obj):
    """The dtype of the first floating or complex tensor an operator stores
    (its attributes in order, nested operators included), or None: the JAX
    package's ``LinOp.dtype`` over its leaves, without its f32 default."""
    if isinstance(obj, torch.Tensor):
        return obj.dtype if obj.is_floating_point() or obj.is_complex() \
            else None
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif isinstance(obj, LinOp):
        items = vars(obj).values()
    else:
        return None
    for item in items:
        dtype = _value_dtype(item)
        if dtype is not None:
            return dtype
    return None


def solve(A, b, x0=None, *, criteria=None, solver=None, preconditioner=None,
          relaxation_factor=1.0, trace: bool = False):
    """Solve A x = b with iterative refinement on the device of A and b.

    ``solver``: the inner correction solver (LinOp or factory); Ginkgo's
    ``with_solver``.  ``preconditioner`` is accepted as an alias so IR slots
    into the generic factory machinery.
    """
    b2, x, squeeze = prepare_rhs(A, b, x0)
    inner = solver if solver is not None else preconditioner
    S = resolve_precond(inner, A)
    if criteria is None:
        criteria = default_criterion(b2.dtype)
    omega = torch.tensor(relaxation_factor, dtype=b2.dtype, device=b2.device)

    r = b2 - A._apply(x)
    state = dict(x=x, r=r)
    b_norm = compute_norm2(b2)
    r0_norm = compute_norm2(r)

    # Inner-solver working precision (the mixed-precision-IR hook), the JAX
    # package's rule: the inner solver's storage precision when it stores
    # values (the Identity stores none and keeps the residual's type), kept
    # complex for a complex residual (a real-storage inner solver then runs
    # in the matching complex precision).
    inner_dt = _value_dtype(S) or b2.dtype
    if is_complex(b2.dtype) and not is_complex(inner_dt):
        inner_dt = complex_dtype(inner_dt)

    def step(s, active):
        d = S._apply(s["r"].to(inner_dt)).to(s["r"].dtype)
        x = s["x"] + omega * d
        return dict(x=x, r=b2 - A._apply(x))

    def make_check_args(s, it):
        return CheckArgs(iteration=it, residual=s["r"])

    final, history = run_iteration_loop(
        step, make_check_args, state, criteria, b2, r0_norm, b_norm,
        trace=trace)
    return finish(final, history, final["state"]["x"], final["state"]["r"],
                  squeeze)


Ir = SolverAPI("Ir", solve)
Richardson = Ir
