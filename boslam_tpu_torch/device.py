"""Device selection for the port's entry points.

The port is written for one CUDA card.  An entry point called without a
device runs there, and raises when the process sees no card: a silent fall
back to the CPU would let a slow run pass for a GPU run.  ``device="cpu"``
is the explicit way onto the plain PyTorch path (the CPU tests use it).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; anything else as given.  A CUDA device raises
    without a card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "boslam_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return device


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices name the same one (``cuda`` is the current card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)
