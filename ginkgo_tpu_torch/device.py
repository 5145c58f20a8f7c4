"""Where the port's entry points put their tensors.

The port runs on the card: an entry point given ``device=None`` places its
tensors on ``cuda`` and raises when there is none.  The host is used only
when the caller asks for it (``device="cpu"``), as the CPU tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); else ``torch.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ginkgo_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the host")
        return torch.device("cuda")
    return torch.device(device)


def matrix_data_and_device(A):
    """(host MatrixData, target device) of a factory's input: a port
    operator keeps its device; plain MatrixData goes to the default
    device (``resolve_device(None)``, the card)."""
    data = A.to_matrix_data() if hasattr(A, "to_matrix_data") else A
    return data, resolve_device(getattr(A, "device", None))
