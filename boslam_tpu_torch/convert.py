"""Carry engine state between the JAX package and the port, as numpy.

The caller turns a JAX NamedTuple into ``{field: np.ndarray}`` (for example
``{k: np.asarray(v) for k, v in state._asdict().items()}``), so this module
never sees JAX.  uint32 descriptor words become int32 tensors holding the
same bits, and back.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from boslam_tpu_torch.features.frontend import FrameFeatures
from boslam_tpu_torch.loopclosure.vocab import LoopState
from boslam_tpu_torch.mapping.map_state import MapState
from boslam_tpu_torch.tracking.tracker import TrackState


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: the source may be read-only
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _from_numpy(cls, d: Mapping[str, np.ndarray], device):
    missing = set(cls._fields) - set(d)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(**{k: _to_tensor(d[k], device) for k in cls._fields})


def _to_numpy(state, uint32_fields=()) -> dict:
    out = {}
    for k, v in state._asdict().items():
        a = v.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k in uint32_fields else a
    return out


def map_state_from_numpy(d: Mapping[str, np.ndarray], device) -> MapState:
    return _from_numpy(MapState, d, device)


def map_state_to_numpy(ms: MapState) -> dict:
    return _to_numpy(ms, ("kf_desc", "pt_desc"))


def track_state_from_numpy(d: Mapping[str, np.ndarray], device) -> TrackState:
    return _from_numpy(TrackState, d, device)


def track_state_to_numpy(ts: TrackState) -> dict:
    return _to_numpy(ts)


def frame_features_from_numpy(d: Mapping[str, np.ndarray], device) -> FrameFeatures:
    return _from_numpy(FrameFeatures, d, device)


def frame_features_to_numpy(f: FrameFeatures) -> dict:
    return _to_numpy(f, ("desc",))


def loop_state_from_numpy(d: Mapping[str, np.ndarray], device) -> LoopState:
    return _from_numpy(LoopState, d, device)


def loop_state_to_numpy(ls: LoopState) -> dict:
    return _to_numpy(ls, ("vocab",))
