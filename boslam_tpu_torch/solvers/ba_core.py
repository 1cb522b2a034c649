"""Shared bundle-adjustment machinery (``boslam_tpu.solvers.ba_core``): edge
residuals and Jacobians on an edge list, IRLS weights, the robust cost and
the batched 3x3 inverse.

An edge connects (camera c, point p) with measurement (uv, depth, octave).
Residual rows: [du, dv, w_d * dz]; Jacobians with respect to the camera's
left-multiplied twist (omega, v) and to the world point.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.geometry import camera as cam_mod
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.solvers import robust


class BaEdges(NamedTuple):
    """Static-shape edge list for a BA problem."""

    cam: torch.Tensor       # [E] i32 camera index
    pt: torch.Tensor        # [E] i32 point index
    uv: torch.Tensor        # [E, 2] f32 measured pixels
    depth: torch.Tensor     # [E] f32 measured keypoint depth (0 = none)
    has_depth: torch.Tensor # [E] bool
    info: torch.Tensor      # [E] f32 information weight (per octave)
    valid: torch.Tensor     # [E] bool


def edge_residuals(cfg: SlamConfig, poses, pts, edges: BaEdges):
    """Residuals r [E, 3] and Jacobians (J_cam [E, 3, 6], J_pt [E, 3, 3]).

    poses: [C, 7] T_cw per camera; pts: [L, 3] world points.  An edge that
    is invalid or lies behind its camera (z <= 1e-3) has r and both
    Jacobians zero.
    """
    cam = cfg.camera
    w_d = cfg.tracker.depth_weight
    pose_e = poses[edges.cam.long()]           # [E, 7]
    X = pts[edges.pt.long()]                   # [E, 3]
    xc = se3.pose_apply(pose_e, X)
    uv_pred = cam_mod.project(cam, xc)
    r_uv = uv_pred - edges.uv
    r_z = torch.where(edges.has_depth, w_d * (xc[..., 2] - edges.depth), 0.0)
    r = torch.cat([r_uv, r_z[..., None]], dim=-1)

    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(
        xc.shape[:-1] + (3, 3))
    dxc_dxi = torch.cat([-se3.hat(xc), eye], dim=-1)   # [E, 3, 6]
    Jp2 = cam_mod.project_jacobian(cam, xc)            # [E, 2, 3] d uv / d xc
    R = se3.quat_to_mat(pose_e[..., :4])               # [E, 3, 3] d xc / d X
    zsel = edges.has_depth[:, None, None]
    J_cam = torch.cat(
        [Jp2 @ dxc_dxi, torch.where(zsel, w_d * dxc_dxi[:, 2:3, :], 0.0)],
        dim=-2,
    )                                                  # [E, 3, 6]
    J_pt = torch.cat(
        [Jp2 @ R, torch.where(zsel, w_d * R[:, 2:3, :], 0.0)], dim=-2
    )                                                  # [E, 3, 3]

    bad = (xc[..., 2] <= 1e-3) | ~edges.valid
    r = torch.where(bad[:, None], 0.0, r)
    J_cam = torch.where(bad[:, None, None], 0.0, J_cam)
    J_pt = torch.where(bad[:, None, None], 0.0, J_pt)
    return r, J_cam, J_pt


def robust_weights(cfg: SlamConfig, r, edges: BaEdges, delta: float):
    """IRLS edge weights: Huber(chi2) * info * valid; returns (w, chi2)."""
    chi2 = torch.sum(r * r, dim=-1) * edges.info
    w = robust.huber_weight(chi2, delta) * edges.info
    return torch.where(edges.valid, w, 0.0), chi2


def robust_cost(cfg: SlamConfig, poses, pts, edges: BaEdges, delta: float):
    """Sum of the Huber costs of the valid edges."""
    r, _, _ = edge_residuals(cfg, poses, pts, edges)
    chi2 = torch.sum(r * r, dim=-1) * edges.info
    return torch.sum(torch.where(edges.valid, robust.huber_cost(chi2, delta), 0.0))


def inv3x3(M):
    """Batched 3x3 inverse via adjugate (safe for SPD damped blocks)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack(
        [
            A, -(b * i - c * h), b * f - c * e,
            B, a * i - c * g, -(a * f - c * d),
            C, -(a * h - b * g), a * e - b * d,
        ],
        dim=-1,
    ).reshape(M.shape)
    return adj / det[..., None, None]
