"""Two-tier kernel registry (``ginkgo_tpu/ops/registry.py`` in torch).

The moral equivalent of Ginkgo's ``GKO_REGISTER_OPERATION`` +
``Executor::run`` double dispatch: a ``reference`` tier (plain torch — runs
on any device, is the numerical oracle) and a ``cuda`` tier (kernels
written by hand for Hopper).  The tier follows the device of the operand
tensors; ``use_tier`` overrides it within a scope.

No quiet fallback: a name with a ``cuda`` implementation, called on CUDA
tensors, runs that implementation, which launches its kernel or raises.
Names with only a ``reference`` implementation (``coo_spmv``) run their
plain-torch version on whatever device the tensors are on.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_kernels: dict[str, dict[str, object]] = {}
_local = threading.local()


def register(name: str, tier: str):
    """Decorator: register ``fn`` as the ``tier`` implementation of ``name``."""

    def deco(fn):
        _kernels.setdefault(name, {})[tier] = fn
        return fn

    return deco


def current_tier(device) -> str:
    """The override of ``use_tier`` if set, else ``cuda`` for operands on a
    CUDA device and ``reference`` otherwise."""
    override = getattr(_local, "tier", None)
    if override is not None:
        return override
    return "cuda" if torch.device(device).type == "cuda" else "reference"


@contextlib.contextmanager
def use_tier(tier: str):
    """Force a tier (e.g. ``reference`` for oracle runs) within a scope."""
    prev = getattr(_local, "tier", None)
    _local.tier = tier
    try:
        yield
    finally:
        _local.tier = prev


def lookup(name: str, device):
    """Resolve a kernel for operands on ``device``: the tier's
    implementation; a name without a ``cuda`` one runs its ``reference``
    implementation on the card too."""
    impls = _kernels.get(name)
    if not impls:
        raise KeyError(f"no kernel registered under {name!r}")
    tier = current_tier(device)
    if tier == "cuda" and "cuda" not in impls:
        tier = "reference"
    if tier not in impls:
        raise KeyError(f"no {tier!r} kernel registered under {name!r}")
    return impls[tier]
