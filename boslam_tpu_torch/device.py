"""Device selection for the port's entry points.

The port is written for one CUDA card.  An entry point called without a
device runs there, and raises when the process sees no card: a silent fall
back to the CPU would let a slow run pass for a GPU run.  ``device="cpu"``
is the explicit way onto the plain PyTorch path (the CPU tests use it).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "boslam_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)
