"""The mesh of parts: the port's counterpart of ``jax.sharding.Mesh``.

The JAX package runs one program over a device mesh: every distributed
operator holds arrays with a leading part axis P, every vector is one
global padded array, and each SpMV is one ``shard_map`` region.  The port
keeps that single-controller model in one process: a ``Mesh`` names the
device of each part, the stacked ``(P, ...)`` arrays live on it, and the
halo exchange is a transpose or a roll over the part axis on that device.

Every part of a mesh must name the same device.  On one card the P parts
are co-resident: the exchange is real work on the card, but it measures
no scaling.  Parts on several cards (the exchange by peer copies or NCCL's
``all_to_all_single``) are ROADMAP.md queue 1 item 14; a mesh naming
different devices raises ``NotSupportedError`` until then.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base.exceptions import NotSupportedError
from ..device import resolve_device

MULTI_DEVICE = ("a mesh whose parts name different devices ({}) needs the "
                "parts placed on several cards, which the port does not "
                "have yet (ROADMAP.md queue 1 item 14); put every part on "
                "one device")


class Mesh:
    """``Mesh(devices, axis_names)``: ``devices`` an array of devices
    (``torch.device`` or names) whose shape is the mesh's shape, one axis
    name per dimension, as ``jax.sharding.Mesh`` takes them."""

    def __init__(self, devices, axis_names):
        flat = [torch.device(d) for d in np.asarray(devices,
                                                     dtype=object).ravel()]
        shape = np.shape(np.asarray(devices, dtype=object))
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh of shape {shape} needs {len(shape)} axis "
                             f"names, got {axis_names}")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(shape)
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """The one device every part names; raises ``NotSupportedError``
        when they differ."""
        devs = sorted({str(d) for d in self.devices.ravel()})
        if len(devs) != 1:
            raise NotSupportedError(MULTI_DEVICE.format(", ".join(devs)))
        return self.devices.ravel()[0]

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.ravel()})
        return f"Mesh({self.shape}, devices={devs})"


def make_mesh(shape, axis_names, device=None) -> Mesh:
    """A mesh of ``shape`` with every part on ``device`` (``None``: the CUDA
    device; raises when there is none, never falls back to the host)."""
    device = resolve_device(device)
    shape = tuple(int(s) for s in np.atleast_1d(shape))
    devices = np.empty(int(np.prod(shape)), dtype=object)
    devices[:] = [device] * devices.size
    return Mesh(devices.reshape(shape), axis_names)


def mesh_device(mesh) -> torch.device:
    """Where a mesh's parts live: the host for the reference's
    ``"schedule-only"`` builds (planning inspected, never applied)."""
    if isinstance(mesh, str):
        if mesh != "schedule-only":
            raise ValueError(f"unknown mesh {mesh!r}")
        return torch.device("cpu")
    return mesh.device
