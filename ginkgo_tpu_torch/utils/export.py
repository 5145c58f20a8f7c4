"""Solves as portable artifacts (``ginkgo_tpu/utils/export.py``'s contract
in torch).

The JAX package exports a configured solve — the operator's structure and
the solve's settings baked in — to a StableHLO program (``jax.export``),
with A's values and b as runtime inputs.  The port's solvers are host
loops that read the device once an iteration, which ``torch.export``
cannot trace into one graph.  So here the artifact holds the operator's
structure (its index tensors and static fields, with a numbered slot for
each value tensor), the solve function (by its import path) and its
keyword settings, and ``load_solve`` rebuilds the same solve in the port:
one artifact serves every matrix sharing the pattern (time-stepping,
parameter sweeps).  The artifact is a pickle: load only artifacts this
program wrote.
"""

from __future__ import annotations

import dataclasses
import io

import torch

from ..device import resolve_device
from .checkpoint import _Slot, _walk


@dataclasses.dataclass(frozen=True)
class _ValueSlot(_Slot):
    """Where runtime value tensor ``index`` goes, with the shape and type
    the artifact takes there."""

    shape: tuple = ()
    dtype: torch.dtype = None


def _is_value(t) -> bool:
    return t.is_floating_point() or t.is_complex()


def value_tensors(A) -> list:
    """A's value (floating and complex) tensors, in the order an exported
    solve takes them."""
    out = []
    _walk(A, lambda t: out.append(t) if _is_value(t) else None, {})
    return out


class ExportedSolve:
    """``solve_fn(A, b, **solve_kwargs).x`` with A's pattern baked in; call
    it with A's value tensors (or an operator of the same pattern) and b.
    """

    def __init__(self, solve_fn, structure, leaves, b_shape, b_dtype,
                 solve_kwargs):
        self.solve_fn = solve_fn
        self.structure = structure        # A with _Slot/_ValueSlot markers
        self.leaves = leaves              # A's index tensors, on the host
        self.b_shape = tuple(b_shape)
        self.b_dtype = b_dtype
        self.solve_kwargs = solve_kwargs

    def serialize(self) -> bytes:
        buf = io.BytesIO()
        torch.save(vars(self), buf)
        return buf.getvalue()

    def call(self, A_or_values, b):
        values = (list(A_or_values) if isinstance(A_or_values, (list, tuple))
                  else value_tensors(A_or_values))
        if tuple(b.shape) != self.b_shape or b.dtype != self.b_dtype:
            raise ValueError(f"b of shape {tuple(b.shape)} and type {b.dtype}"
                             f"; the solve takes {self.b_shape}, "
                             f"{self.b_dtype}")
        device = values[0].device if values else b.device
        taken = set()

        def fill(slot):
            if isinstance(slot, _ValueSlot):
                v = values[slot.index]
                if tuple(v.shape) != slot.shape or v.dtype != slot.dtype:
                    raise ValueError(
                        f"value tensor {slot.index} of shape "
                        f"{tuple(v.shape)} and type {v.dtype}; the solve "
                        f"takes {slot.shape}, {slot.dtype}")
                taken.add(slot.index)
                return v
            leaf = self.leaves[slot.index]
            # a tensor the operator kept on the host stays there
            return leaf if slot.host else leaf.to(device)

        A = _walk(self.structure, fill, {})
        if len(taken) != len(values):
            raise ValueError(f"{len(values)} value tensors for a solve that "
                             f"takes {len(taken)}")
        return self.solve_fn(A, b, **self.solve_kwargs).x


def export_solve(solve_fn, A_template, b_like, **solve_kwargs):
    """Export ``x = solve_fn(A, b, **solve_kwargs).x`` with A's pattern and
    static structure baked in and (A's value tensors, b) as runtime
    inputs; ``b_like`` gives b's shape and type (a tensor, or one on the
    ``meta`` device).  Returns an :class:`ExportedSolve` (``.serialize()``
    for bytes)."""
    leaves, index, counter = [], {}, [0]
    on_card = resolve_device(A_template.device).type != "cpu"

    def mark(t):
        if _is_value(t):
            counter[0] += 1
            return _ValueSlot(counter[0] - 1, False, tuple(t.shape),
                              t.dtype)
        if id(t) not in index:
            index[id(t)] = len(leaves)
            leaves.append(t.detach().cpu())
        return _Slot(index[id(t)], on_card and t.device.type == "cpu")

    structure = _walk(A_template, mark, {})
    return ExportedSolve(solve_fn, structure, leaves, b_like.shape,
                         b_like.dtype, solve_kwargs)


def serialize_solve(solve_fn, A_template, b_like, **solve_kwargs) -> bytes:
    return export_solve(solve_fn, A_template, b_like,
                        **solve_kwargs).serialize()


def load_solve(blob: bytes):
    """Deserialize; returns a callable ``run(A_or_values, b) -> x``."""
    state = torch.load(io.BytesIO(blob), map_location="cpu",
                       weights_only=False)
    return ExportedSolve(**state).call
