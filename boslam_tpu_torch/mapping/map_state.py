"""The global map as a fixed-capacity NamedTuple of tensors.

The map is pure data: dense tensors with validity masks and a free-list
allocation discipline, the layout of ``boslam_tpu.mapping.map_state``.
Canonical observation structure: ``kf_obs_pt[k, s]`` = map-point id observed
at keypoint slot ``s`` of keyframe ``k`` (-1 if none).  Covisibility weights,
observation counts and the spanning tree derive from it; the covisibility
matrix is one matrix product of the keyframe/point incidence matrix.

Descriptor words (``kf_desc``, ``pt_desc``) are int32 tensors holding the
reference's uint32 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.utils.tensor_ops import at, top_k

MAX_LOOP_EDGES = 32


class MapState(NamedTuple):
    # --- keyframes ------------------------------------------------------
    kf_pose: torch.Tensor      # [K, 7] f32 T_cw
    kf_valid: torch.Tensor     # [K] bool
    kf_uv: torch.Tensor        # [K, N, 2] f32 keypoint pixels (level-0)
    kf_depth: torch.Tensor     # [K, N] f32 keypoint depth (0 = none)
    kf_desc: torch.Tensor      # [K, N, 8] i32 descriptor words
    kf_octave: torch.Tensor    # [K, N] i32
    kf_angle: torch.Tensor     # [K, N] f32 keypoint orientation (radians)
    kf_kp_valid: torch.Tensor  # [K, N] bool
    kf_obs_pt: torch.Tensor    # [K, N] i32 observed point id, -1 = none
    kf_frame_idx: torch.Tensor # [K] i32 source frame index
    kf_seq: torch.Tensor       # [K] i32 insertion sequence number (-1 = never used)
    n_kf: torch.Tensor         # scalar i32 MONOTONIC total insertions (seq source)
    # --- map points -----------------------------------------------------
    pt_xyz: torch.Tensor       # [P, 3] f32 world positions
    pt_desc: torch.Tensor      # [P, 8] i32 representative descriptor words
    pt_angle: torch.Tensor     # [P] f32 orientation of the representative observation
    pt_valid: torch.Tensor     # [P] bool
    pt_ref_kf: torch.Tensor    # [P] i32 creating keyframe
    pt_first_kf: torch.Tensor  # [P] i32 n_kf at creation (recency for culling)
    pt_n_vis: torch.Tensor     # [P] i32 times predicted visible in tracking
    pt_n_found: torch.Tensor   # [P] i32 times matched as tracking inlier
    # Viewing model: un-normalized sum of per-observation unit directions
    # point->camera (world frame; ~0 means "no data"), and the scale-
    # invariance distance band predicted from the observing octave.
    pt_dir_sum: torch.Tensor   # [P, 3] f32 sum of unit view directions
    pt_dmin: torch.Tensor      # [P] f32 min predicted view distance (0 = unset)
    pt_dmax: torch.Tensor      # [P] f32 max predicted view distance (0 = unset)
    # --- derived / graph ------------------------------------------------
    covis: torch.Tensor        # [K, K] i32 co-observation counts (symmetric)
    spanning_parent: torch.Tensor  # [K] i32 parent keyframe id (-1 for root)
    loop_edges: torch.Tensor   # [MAX_LOOP_EDGES, 2] i32 keyframe pairs
    loop_rel: torch.Tensor     # [MAX_LOOP_EDGES, 7] f32 measured T_ci_cj
    n_loop_edges: torch.Tensor # scalar i32


def empty_map(cfg: SlamConfig, device) -> MapState:
    K = cfg.map.max_keyframes
    P = cfg.map.max_points
    N = cfg.orb.n_features
    i32 = torch.int32

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, v, dtype=i32):
        return torch.full(shape, v, dtype=dtype, device=device)

    kf_pose = z(K, 7)
    kf_pose[:, 0] = 1.0
    loop_rel = z(MAX_LOOP_EDGES, 7)
    loop_rel[:, 0] = 1.0
    return MapState(
        kf_pose=kf_pose,
        kf_valid=z(K, dtype=torch.bool),
        kf_uv=z(K, N, 2),
        kf_depth=z(K, N),
        kf_desc=z(K, N, 8, dtype=i32),
        kf_octave=z(K, N, dtype=i32),
        kf_angle=z(K, N),
        kf_kp_valid=z(K, N, dtype=torch.bool),
        kf_obs_pt=full((K, N), -1),
        kf_frame_idx=z(K, dtype=i32),
        kf_seq=full((K,), -1),
        n_kf=z(dtype=i32),
        pt_xyz=z(P, 3),
        pt_desc=z(P, 8, dtype=i32),
        pt_angle=z(P),
        pt_valid=z(P, dtype=torch.bool),
        pt_ref_kf=z(P, dtype=i32),
        pt_first_kf=z(P, dtype=i32),
        pt_n_vis=z(P, dtype=i32),
        pt_n_found=z(P, dtype=i32),
        pt_dir_sum=z(P, 3),
        pt_dmin=z(P),
        pt_dmax=z(P),
        covis=z(K, K, dtype=i32),
        spanning_parent=full((K,), -1),
        loop_edges=z(MAX_LOOP_EDGES, 2, dtype=i32),
        loop_rel=loop_rel,
        n_loop_edges=z(dtype=i32),
    )


def free_kf_slot(state: MapState):
    """(slot, has_free): first invalid keyframe slot, free-list allocation."""
    free = ~state.kf_valid
    slot = torch.argmax(free.to(torch.int32)).to(torch.int32)
    return slot, at(free, slot)


def latest_kf_slot(state: MapState):
    """Slot of the most recently inserted valid keyframe (argmax kf_seq)."""
    seq = torch.where(state.kf_valid, state.kf_seq, -1)
    return torch.argmax(seq).to(torch.int32)


def incidence(state: MapState) -> torch.Tensor:
    """Keyframe x point observation incidence O[k, p] in {0, 1} (f32)."""
    K, N = state.kf_obs_pt.shape
    P = state.pt_xyz.shape[0]
    obs = state.kf_obs_pt
    has = (obs >= 0) & state.kf_valid[:, None]
    tgt = torch.where(has, obs, P).long()  # P = dump column
    O = torch.zeros((K, P + 1), dtype=torch.float32, device=obs.device)
    O.scatter_(1, tgt, 1.0)
    return O[:, :P] * state.pt_valid[None, :].to(torch.float32)


def recompute_covis(state: MapState) -> MapState:
    """Refresh covisibility weights from the canonical observation table.
    Counts of 0/1 products are exact in float32 in any summation order."""
    O = incidence(state)
    covis = (O @ O.T).to(torch.int32)
    K = covis.shape[0]
    covis = covis * (1 - torch.eye(K, dtype=torch.int32, device=covis.device))
    return state._replace(covis=covis)


def point_obs_count(state: MapState) -> torch.Tensor:
    """[P] i32 — number of valid keyframes observing each point."""
    return torch.sum(incidence(state), dim=0).to(torch.int32)


def covis_neighbors(state: MapState, kf_id, k: int, min_weight: int):
    """Top-k covisible keyframes of ``kf_id``: (ids [k], weights [k], mask)."""
    row = at(state.covis, kf_id) * state.kf_valid
    w, ids = top_k(row, k)
    mask = w >= min_weight
    return ids, w, mask
