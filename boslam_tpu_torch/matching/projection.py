"""Projection-guided matching of frame keypoints to map points.

Project the map points into the frame with the predicted pose, compute the
full keypoints x points Hamming matrix, and mask it by the octave-scaled
projection window and the view-angle / distance-band / octave gates.
"""

from __future__ import annotations

import math

import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.geometry import camera as cam_mod
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.matching import hamming
from boslam_tpu_torch.matching.rotation import rotation_consistency


def project_points(cfg: SlamConfig, pose_cw, pt_xyz, pt_valid):
    """Project world points into the camera.

    Returns (uv [P, 2], z_cam [P], visible [P]): in front of the camera,
    inside the image, and within the depth validity range.
    """
    cam = cfg.camera
    xc = se3.pose_apply(pose_cw[None, :], pt_xyz)
    uv = cam_mod.project(cam, xc)
    z = xc[..., 2]
    vis = (
        pt_valid
        & (z > cam.depth_min)
        & (z < cam.depth_max)
        & cam_mod.in_image(cam, uv, border=1.0)
    )
    return uv, z, vis


VIEW_COS_MIN = 0.5        # reject view angle > 60 deg off normal
VIEW_DIST_LO = 0.8        # dmin * 0.8 <= dist <= dmax * 1.2
VIEW_DIST_HI = 1.2


def search_by_projection(
    cfg: SlamConfig,
    feats,
    pose_cw,
    pt_xyz,
    pt_desc,
    pt_valid,
    radius: float,
    max_dist: int,
    ratio: float | None = None,
    mutual: bool = True,
    pt_angle=None,
    pt_dir_sum=None,
    pt_dmin=None,
    pt_dmax=None,
):
    """Match frame keypoints to map points under a predicted pose.

    Args:
      feats: FrameFeatures of the current frame.
      pose_cw: [7] predicted world->camera pose.
      pt_xyz: [P, 3] world positions; pt_desc: [P, 8] words; pt_valid: [P].
      radius: base search radius in pixels (scaled by keypoint octave).
      pt_dir_sum / pt_dmin / pt_dmax: optional viewing model (MapState
        fields) gating view-angle cosine, the distance band and octave
        compatibility.  Points with an unset model pass ungated.

    Returns:
      (match_idx [N] int32 point index or -1, match_mask [N] bool,
       visible [P] bool, match_dist [N] i32)
    """
    mcfg = cfg.matcher
    uv_proj, z, vis = project_points(cfg, pose_cw, pt_xyz, pt_valid)
    sf = cfg.orb.scale_factor
    pair_mask = None
    if pt_dir_sum is not None:
        cam_w = se3.pose_inv(pose_cw)[4:7]
        dvec = cam_w[None, :] - pt_xyz                       # [P, 3]
        dist = torch.linalg.vector_norm(dvec, dim=-1)
        nrm = torch.linalg.vector_norm(pt_dir_sum, dim=-1)
        cosv = torch.sum(dvec * pt_dir_sum, dim=-1) / torch.clamp(
            dist * nrm, min=1e-9
        )
        ok_angle = (cosv >= VIEW_COS_MIN) | (nrm < 1e-6)
        has_band = pt_dmax > 0
        ok_dist = ~has_band | (
            (dist >= VIEW_DIST_LO * pt_dmin) & (dist <= VIEW_DIST_HI * pt_dmax)
        )
        vis = vis & ok_angle & ok_dist
        # Octave compatibility: the level at which the point should appear
        # at this distance must be within +-1 of the keypoint's octave.
        pred = torch.log(torch.clamp(pt_dmax, min=1e-9)
                         / torch.clamp(dist, min=1e-9))
        pred = torch.clamp(torch.ceil(pred / math.log(sf)), 0,
                           cfg.orb.n_levels - 1)
        d_oct = torch.abs(feats.octave.to(torch.float32)[:, None] - pred[None, :])
        pair_mask = (d_oct <= 1.0) | ~has_band[None, :]
    # Octave-scaled window around each keypoint.
    scale = torch.pow(sf, feats.octave.to(torch.float32))
    r = radius * scale  # [N]
    d2 = torch.sum((feats.uv[:, None, :] - uv_proj[None, :, :]) ** 2, dim=-1)
    window = (d2 <= (r[:, None] ** 2)) & vis[None, :]
    if pair_mask is not None:
        window = window & pair_mask
    dist = hamming.hamming_matrix_mxu(feats.desc, pt_desc)
    idx, ok, mdist = hamming.match_top2(
        dist,
        feats.valid,
        vis,
        max_dist=max_dist,
        ratio=mcfg.ratio if ratio is None else ratio,
        mutual=mutual,
        extra_mask=window,
    )
    if pt_angle is not None:
        # Rotation-consistency histogram: mismatches scatter in relative
        # orientation while true matches share the camera-roll offset.
        matched_angle = pt_angle[torch.clamp(idx.long(), 0, pt_angle.shape[0] - 1)]
        keep = rotation_consistency(feats.angle, matched_angle, ok)
        idx = torch.where(keep, idx, -1)
        ok = keep
    return idx, ok, vis, mdist
