"""Process-group mesh (``boslam_tpu.parallel.mesh``).

The engine's two parallel axes, over the ranks of ``torch.distributed``
(one device per rank):

- ``seq``: data parallelism over independent camera sequences;
- ``pt``: landmark blocks and their BA edges sharded over ranks, camera
  poses replicated.

The reference's ``Mesh`` names devices and lets XLA place the collectives;
here a mesh names ranks, and ``group(axis)`` is the process group along
that axis that the sharded solvers hand to ``all_reduce`` / ``all_gather``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch.distributed as dist

AXES = ("seq", "pt")


@dataclass(frozen=True, eq=False)
class Mesh:
    """``ranks`` [seq, pt] global ranks; ``shape`` {"seq": s, "pt": p}."""

    ranks: np.ndarray
    shape: dict
    _groups: Optional[dict] = None  # axis -> this rank's group (None: size 1)

    def group(self, axis: str):
        """This rank's process group along ``axis``; ``None`` when the axis
        has size 1 (nothing to reduce over)."""
        if self.shape[axis] == 1:
            return None
        if self._groups is None:
            raise RuntimeError(
                f"mesh axis {axis!r} spans {self.shape[axis]} ranks but no "
                "process group is initialised (parallel.distributed)")
        return self._groups[axis]

    def index(self, axis: str) -> int:
        """This rank's position along ``axis`` (0 without a process group)."""
        if not dist.is_initialized():
            return 0
        s, p = np.argwhere(self.ranks == dist.get_rank())[0]
        return int(s if axis == "seq" else p)


def make_mesh(n_devices: Optional[int] = None, seq: int = 1) -> Mesh:
    """Mesh with axes ('seq', 'pt'); pt gets all ranks not used by seq.

    ``n_devices`` defaults to the world size (1 without a process group).
    The shape needs no process group; the sub-groups are made when one is
    up, by every rank and in the same order, since ``new_group`` is
    collective."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if n_devices % seq != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by seq={seq}")
    pt = n_devices // seq
    ranks = np.arange(n_devices).reshape(seq, pt)
    groups = None
    if dist.is_initialized() and n_devices > 1:
        if n_devices > world:
            raise ValueError(
                f"n_devices={n_devices} exceeds the world size {world}")
        me = dist.get_rank()
        groups = {}
        lines = {"seq": [ranks[:, j] for j in range(pt)],
                 "pt": [ranks[i, :] for i in range(seq)]}
        for axis in AXES:
            if ranks.shape[AXES.index(axis)] == 1:
                continue
            for line in lines[axis]:
                g = dist.new_group([int(r) for r in line])
                if me in line:
                    groups[axis] = g
    return Mesh(ranks, {"seq": seq, "pt": pt}, groups)
