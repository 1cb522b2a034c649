"""Checkpoint / resume of a ``SlamSystem`` (``boslam_tpu.utils.checkpoint``).

The map, loop-closure state, tracker state, the generator's state and the
host trajectory go to one file, ``<path>/state.pt``, by ``torch.save`` of
CPU tensors, and come back by ``torch.load(..., weights_only=True)`` onto
the engine's device.  A run can resume mid-sequence.
"""

from __future__ import annotations

import os

import numpy as np
import torch

STATE_FILE = "state.pt"

# Fields whose shape may differ between the snapshot and the running engine
# (transient trackers whose capacity is a code constant).  On a mismatch
# these reset to the engine's default; any other field with a shape
# mismatch means the snapshot was written under another SlamConfig
# (capacities) and must fail loudly, not restore a half-empty map.
_TRANSIENT_FIELDS = frozenset({"streak_kf", "streak_len"})


def _cpu(state) -> dict:
    return {k: v.detach().cpu() for k, v in state._asdict().items()}


def save(path: str, slam) -> None:
    """Snapshot a SlamSystem's device state and host trajectory into the
    directory ``path``.  Pending work lands first: the flush, any deferred
    local BA and any loop verification in flight."""
    slam.flush()
    slam._merge_pending_ba()
    slam._resolve_pending_verify()
    rows = [np.concatenate([np.asarray([vs, vq, ps, pq], np.float32), rel])
            for (vs, vq), (ps, pq, rel) in slam.cull_chain.items()]
    state = {
        "map": _cpu(slam.map),
        "loop": _cpu(slam.loop),
        "track": _cpu(slam.track),
        "generator": slam.generator.get_state(),
        "timestamps": torch.tensor(slam.timestamps, dtype=torch.float64),
        "poses_twc": torch.from_numpy(
            np.stack(slam.poses_twc) if slam.poses_twc
            else np.zeros((0, 7), np.float32)),
        "n_loops_closed": torch.tensor(slam.n_loops_closed),
        "frame_ref_slot": torch.tensor([r[0] for r in slam.frame_refs],
                                       dtype=torch.int32),
        "frame_ref_seq": torch.tensor([r[1] for r in slam.frame_refs],
                                      dtype=torch.int32),
        "frame_ref_rel": torch.from_numpy(
            np.stack([r[2] for r in slam.frame_refs]) if slam.frame_refs
            else np.zeros((0, 7), np.float32)),
        # victim_slot victim_seq parent_slot parent_seq T_victim_parent(7)
        "cull_chain": torch.from_numpy(
            np.stack(rows) if rows else np.zeros((0, 11), np.float32)),
    }
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{STATE_FILE}.{os.getpid()}")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def _merge(template, saved: dict, device):
    """Rebuild a state NamedTuple from the snapshot.  A field the snapshot
    lacks keeps the template's (empty) value; unknown saved keys are
    ignored; a shape mismatch raises, except on the transient fields."""
    vals = template._asdict()
    for k, v in saved.items():
        if k not in vals:
            continue
        if v.shape != vals[k].shape:
            if k in _TRANSIENT_FIELDS:
                continue
            raise ValueError(
                f"checkpoint field {type(template).__name__}.{k} has shape "
                f"{tuple(v.shape)}, engine expects {tuple(vals[k].shape)}: "
                "was the snapshot written under another SlamConfig "
                "(capacities)?")
        vals[k] = v.to(device)
    return type(template)(**vals)


def restore(path: str, slam) -> None:
    """Restore a SlamSystem in place from the directory ``path`` (its config
    must give the snapshot's shapes)."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    slam.map = _merge(slam.map, state["map"], slam.device)
    slam.loop = _merge(slam.loop, state["loop"], slam.device)
    slam.track = _merge(slam.track, state["track"], slam.device)
    slam.generator.set_state(state["generator"])
    # Resume the vocabulary-refresh schedule from the restored map size.
    slam._vocab_trained_at = (
        int(state["map"]["n_kf"]) if bool(state["loop"]["vocab_ready"]) else -1
    )
    slam.timestamps = state["timestamps"].tolist()
    slam.poses_twc = list(state["poses_twc"].numpy())
    slam.n_loops_closed = int(state["n_loops_closed"])
    slam.frame_refs = [
        (int(s), int(q), r)
        for s, q, r in zip(state["frame_ref_slot"].tolist(),
                           state["frame_ref_seq"].tolist(),
                           state["frame_ref_rel"].numpy())
    ]
    slam.cull_chain = {
        (int(row[0]), int(row[1])): (int(row[2]), int(row[3]), row[4:11])
        for row in state["cull_chain"].numpy()
    }
    # The host mirror of each slot's seq: loop verification needs both
    # endpoints in it, or every closure against a pre-resume keyframe would
    # be dropped.
    slam._kf_seq_host = {
        i: int(s)
        for i, (v, s) in enumerate(zip(slam.map.kf_valid.tolist(),
                                       slam.map.kf_seq.tolist()))
        if v
    }
