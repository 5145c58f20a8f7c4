"""Checkpoint / serialization of operators and solver state
(``ginkgo_tpu/utils/checkpoint.py`` in torch).

The reference has no checkpointing (solves are short); this is the cheap
extra the JAX package adds: any port operator, factorization, multigrid
hierarchy or ``SolveResult`` round-trips through one file — its tensor
leaves beside a structure that holds a numbered slot where each tensor
was — so a long multigrid hierarchy or ParILUT factorization generated
once, or a banded or packed ``Csr``, is reloaded without planning again.

The file is written by ``torch.save`` and read by ``torch.load`` with
``weights_only=False``: the structure is a pickle, so load only files
this program wrote.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from ..base.linop import LinOp
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class _Slot:
    """Where tensor ``index`` of the file's leaves goes, and whether it was
    on the host."""

    index: int
    host: bool


def _walk(obj, fn, memo):
    """A copy of ``obj`` with ``fn`` applied to every tensor or slot it
    holds, through operators, dataclasses, dicts, lists and tuples; an
    object reached twice is copied once."""
    if isinstance(obj, (torch.Tensor, _Slot)):
        return fn(obj)
    key = id(obj)
    if key in memo:
        return memo[key]
    if isinstance(obj, LinOp) or (dataclasses.is_dataclass(obj)
                                  and not isinstance(obj, type)):
        new = copy.copy(obj)
        memo[key] = new
        for name, value in vars(obj).items():
            object.__setattr__(new, name, _walk(value, fn, memo))
        return new
    if isinstance(obj, dict):
        return {k: _walk(v, fn, memo) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_walk(v, fn, memo) for v in obj)
    return obj


def save(path: str, obj) -> None:
    """Save ``obj``'s tensors (to the host) and its structure to exactly
    ``path``."""
    index, leaves = {}, []

    def slot(t):
        if id(t) not in index:
            index[id(t)] = len(leaves)
            leaves.append(t)
        return _Slot(index[id(t)], t.device.type == "cpu")

    structure = _walk(obj, slot, {})
    torch.save({"leaves": [t.detach().cpu() for t in leaves],
                "on_card": any(t.device.type != "cpu" for t in leaves),
                "structure": structure}, path)


def load(path: str, device=None):
    """Inverse of :func:`save`; the tensors go to ``device`` (``None``: the
    CUDA device), but for those an object on the card kept on the host (a
    packed ``Csr``'s slab), which stay there."""
    device = resolve_device(device)
    blob = torch.load(path, map_location="cpu", weights_only=False)
    leaves = blob["leaves"]
    moved = {}

    def fill(s):
        if s.index not in moved:
            keep = blob["on_card"] and s.host
            moved[s.index] = (leaves[s.index] if keep
                              else leaves[s.index].to(device))
        return moved[s.index]

    return _walk(blob["structure"], fill, {})
