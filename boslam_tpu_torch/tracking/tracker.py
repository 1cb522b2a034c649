"""Frame-to-map tracking: constant-velocity prediction, projection-window
matching against the local map, robust GN motion-only BA, then a track-
local-map second pass and re-optimization (``boslam_tpu.tracking.tracker``).

The reference's ``lax.cond`` around the wide fallback pass is a host branch
here: one host synchronization per frame, counted by the caller's
``HostSync``.  Relocalization (the lost path) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.matching import projection
from boslam_tpu_torch.solvers.pose_opt import optimize_pose
from boslam_tpu_torch.utils.tensor_ops import at

ST_UNINIT, ST_OK, ST_LOST = 0, 1, 2


class HostSync:
    """Reads a device scalar on the host for a branch, and counts the
    reads: each is one wait for the device (the reference branches on the
    device with ``lax.cond`` / ``lax.switch``)."""

    def __init__(self) -> None:
        self.count = 0

    def flag(self, t: torch.Tensor) -> bool:
        self.count += 1
        return bool(t)

    def value(self, t: torch.Tensor) -> int:
        self.count += 1
        return int(t)


class TrackState(NamedTuple):
    pose_cw: torch.Tensor    # [7] current camera pose (world -> camera)
    velocity: torch.Tensor   # [7] T_cw(t) ∘ T_cw(t-1)^-1 (motion model)
    status: torch.Tensor     # scalar i32: 0 uninit / 1 ok / 2 lost
    n_since_kf: torch.Tensor # scalar i32 frames since last keyframe
    last_kf: torch.Tensor    # scalar i32 reference keyframe id
    frame_idx: torch.Tensor  # scalar i32


class TrackOut(NamedTuple):
    pose_cw: torch.Tensor
    match_pt: torch.Tensor   # [N] i32 matched map-point id per keypoint (-1)
    match_ok: torch.Tensor   # [N] bool final inlier matches
    visible: torch.Tensor    # [P] bool map points predicted visible this frame
    n_inliers: torch.Tensor  # scalar i32
    n_visible: torch.Tensor  # scalar i32 map points predicted visible
    n_matches: torch.Tensor  # scalar i32 pre-BA matches
    need_kf: torch.Tensor    # scalar bool keyframe-decision hint
    lost: torch.Tensor       # scalar bool
    # [n_inliers, n_matches, n_visible, need_kf, lost] as f32.
    scalars: torch.Tensor


def init_track_state(device) -> TrackState:
    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=device)

    return TrackState(
        pose_cw=se3.pose_identity(device=device),
        velocity=se3.pose_identity(device=device),
        status=i32(ST_UNINIT),
        n_since_kf=i32(0),
        last_kf=i32(0),
        frame_idx=i32(0),
    )


def _local_point_mask(map_state, last_kf):
    """Points observed by the reference keyframe's covisibility
    neighborhood, two rings deep."""
    K = map_state.kf_valid.shape[0]
    P = map_state.pt_valid.shape[0]
    dev = map_state.kf_valid.device
    self_row = torch.arange(K, device=dev) == last_kf
    nb1 = ((at(map_state.covis, last_kf) > 0) | self_row) & map_state.kf_valid
    # Counts up to K * N fit float32 exactly; CUDA has no int32 matmul.
    reach = map_state.covis.to(torch.float32) @ nb1.to(torch.float32)
    nb2 = ((reach > 0) | nb1) & map_state.kf_valid
    obs = map_state.kf_obs_pt                                  # [K, N]
    sel = nb2[:, None] & map_state.kf_kp_valid & (obs >= 0)
    ids = torch.where(sel, obs, P).reshape(-1).long()  # P = dump slot
    out = torch.zeros((P + 1,), dtype=torch.bool, device=dev)
    out[ids] = True
    return out[:P]


def _match_and_optimize(cfg, feats, pose_pred, map_state, pt_mask,
                        radius, max_dist, ratio):
    idx, ok, vis, _ = projection.search_by_projection(
        cfg, feats, pose_pred, map_state.pt_xyz, map_state.pt_desc,
        pt_mask, radius=radius, max_dist=max_dist, ratio=ratio,
        pt_angle=map_state.pt_angle,
        pt_dir_sum=map_state.pt_dir_sum,
        pt_dmin=map_state.pt_dmin,
        pt_dmax=map_state.pt_dmax,
    )
    P = map_state.pt_xyz.shape[0]
    pid = torch.clamp(idx, 0, P - 1).long()
    pts_w = map_state.pt_xyz[pid]
    res = optimize_pose(
        cfg, pose_pred, pts_w, feats.uv, feats.depth,
        feats.has_depth & ok, ok, feats.octave,
    )
    return idx, ok, res, vis


def track_frame(cfg: SlamConfig, map_state, track: TrackState, feats,
                sync: HostSync | None = None):
    """Track one frame against the map.  Returns (TrackState, TrackOut)."""
    sync = HostSync() if sync is None else sync
    tk = cfg.tracker
    mc = cfg.matcher
    pose_pred = se3.pose_compose(track.velocity, track.pose_cw)

    if tk.track_scope == "local":
        pt_mask = map_state.pt_valid & _local_point_mask(map_state, track.last_kf)
    else:
        pt_mask = map_state.pt_valid

    # Pass 1: tight window from motion model.
    idx1, ok1, res1, _ = _match_and_optimize(
        cfg, feats, pose_pred, map_state, pt_mask,
        mc.search_radius, mc.hamming_low, mc.ratio,
    )
    pose1 = res1.pose
    # Fallback: if too few matches, widen (the lost-motion-model path).
    if sync.flag(torch.sum(ok1) < 2 * tk.min_inliers):
        _, _, res1b, _ = _match_and_optimize(
            cfg, feats, pose_pred, map_state, pt_mask,
            mc.search_radius_wide, mc.hamming_high, mc.ratio,
        )
        pose1 = res1b.pose

    # Pass 2: track local map — refined pose, fresh window, re-optimize.
    idx2, ok2, res2, vis2 = _match_and_optimize(
        cfg, feats, pose1, map_state, pt_mask,
        mc.search_radius, mc.hamming_high, 1.0,
    )
    pose = res2.pose
    inl = res2.inliers
    n_inl = res2.n_inliers
    n_match = torch.sum(ok2)

    lost = n_inl < tk.min_inliers
    # Keep the old pose when lost (motion model would drift).
    pose = torch.where(lost, track.pose_cw, pose)
    velocity = torch.where(
        lost, se3.pose_identity(device=pose.device),
        se3.pose_compose(pose, se3.pose_inv(track.pose_cw)),
    )

    # Keyframe policy (reference need_new_keyframe()).
    ref_obs = torch.sum(
        (at(map_state.kf_obs_pt, track.last_kf) >= 0)
        & at(map_state.kf_kp_valid, track.last_kf)
    )
    tracked_ratio = n_inl / torch.clamp(ref_obs, min=1)
    need_kf = (
        ~lost
        & (track.n_since_kf >= tk.kf_min_interval)
        & (
            (track.n_since_kf >= tk.kf_max_interval)
            | (tracked_ratio < tk.kf_tracked_ratio)
            | (n_inl < tk.kf_min_tracked)
        )
    )

    n_vis = torch.sum(vis2).to(torch.int32)
    new_track = TrackState(
        pose_cw=pose,
        velocity=velocity,
        status=torch.where(lost, ST_LOST, ST_OK).to(torch.int32),
        n_since_kf=track.n_since_kf + 1,
        last_kf=track.last_kf,
        frame_idx=track.frame_idx + 1,
    )
    out = TrackOut(
        pose_cw=pose,
        match_pt=torch.where(inl, idx2, -1),
        match_ok=inl & (idx2 >= 0),
        visible=vis2,
        n_inliers=n_inl,
        n_visible=n_vis,
        n_matches=n_match.to(torch.int32),
        need_kf=need_kf,
        lost=lost,
        scalars=torch.stack([
            n_inl.to(torch.float32),
            n_match.to(torch.float32),
            n_vis.to(torch.float32),
            need_kf.to(torch.float32),
            lost.to(torch.float32),
        ]),
    )
    return new_track, out
