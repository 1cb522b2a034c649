"""Keyframe-anchored trajectory resolution (the trajectory-dump policy).

Every tracked frame records (reference keyframe slot, kf_seq, T_cur_ref); at
dump time it is re-anchored to the CURRENT pose of that keyframe, so later
corrections of the keyframe still correct the frame.  Frames whose reference
keyframe was CULLED chase the cull chain (victim -> spanning parent -> ... ->
live keyframe), composing the relative poses recorded at cull time; only an
unresolvable chain falls back to the raw pose.  Host-side, on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from boslam_tpu_torch.geometry import se3

_MAX_HOPS = 64


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return se3.pose_compose(torch.from_numpy(np.asarray(a, np.float32)),
                            torch.from_numpy(np.asarray(b, np.float32))).numpy()


def anchor_trajectory(raw, frame_refs, cull_chain, kf_pose, kf_valid, kf_seq):
    """Re-anchor raw frame poses to their (corrected) reference keyframes.

    Args:
      raw: [T, 7] f32 raw T_wc poses recorded at track time.
      frame_refs: list of (ref_slot, ref_seq, T_cur_ref [7]) per frame.
      cull_chain: {(victim_slot, victim_seq): (parent_slot, parent_seq,
        T_victim_parent [7])} — records written when keyframes were culled.
      kf_pose / kf_valid / kf_seq: the map's CURRENT keyframe arrays (numpy).

    Returns [T, 7] anchored poses; frames whose chain does not resolve to a
    live keyframe keep their raw pose.
    """
    refs = np.array([r[0] for r in frame_refs])
    seqs = np.array([r[1] for r in frame_refs])
    rels = np.stack([r[2] for r in frame_refs]).astype(np.float32)

    def live(slot, seq):
        return kf_valid[slot] and kf_seq[slot] == seq

    resolved: dict = {}
    for i in range(len(refs)):
        key = (int(refs[i]), int(seqs[i]))
        if live(*key):
            continue
        if key not in resolved:
            slot, seq = key
            acc = se3.pose_identity().numpy()
            hops = 0
            while (slot, seq) in cull_chain and hops < _MAX_HOPS:
                pslot, pseq, t_vp = cull_chain[(slot, seq)]
                acc = _compose(acc, t_vp)
                slot, seq = pslot, pseq
                hops += 1
            resolved[key] = (slot, seq, acc) if live(slot, seq) else None
        hit = resolved[key]
        if hit is not None:
            slot, seq, acc = hit
            refs[i], seqs[i] = slot, seq
            rels[i] = _compose(rels[i], acc)
    usable = kf_valid[refs] & (kf_seq[refs] == seqs)
    T_cw = se3.pose_compose(torch.from_numpy(rels),
                            torch.from_numpy(np.asarray(kf_pose[refs], np.float32)))
    anchored = se3.pose_inv(T_cw).numpy()
    return np.where(usable[:, None], anchored, raw)
