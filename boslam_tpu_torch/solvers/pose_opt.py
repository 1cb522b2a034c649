"""Motion-only bundle adjustment: robust Gauss-Newton on one SE3 pose.

Residual per observation (RGBD): [u_pred - u_obs, v_pred - v_obs,
w_d * (z_pred - z_obs)].  ``optimize_pose`` runs the whole optimizer as one
launch of the ``pose_gn`` kernel for CUDA tensors (``ops.pose_cuda``, the
counterpart of the reference's ``lax.scan`` loops compiled into one
program) and ``optimize_pose_plain`` for CPU tensors.  In the plain version
all edges are evaluated batched, the 6x6 normal system is two einsums, the
damped solve a 6x6 Cholesky, and the reference's ``lax.scan`` loops are
Python loops.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.geometry import camera as cam_mod
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.ops import pose_cuda
from boslam_tpu_torch.solvers import robust


class PoseOptResult(NamedTuple):
    pose: torch.Tensor       # [7] refined T_cw
    inliers: torch.Tensor    # [N] bool final inlier mask
    n_inliers: torch.Tensor  # scalar i32
    chi2: torch.Tensor       # scalar final robust cost


def pose_residuals(cfg: SlamConfig, pose_cw, pts_w, uv_obs, depth_obs, has_depth):
    """Batched residuals r [..., N, 3] and Jacobians J [..., N, 3, 6] wrt
    left-mult twist update exp(xi) ∘ T_cw, xi = (omega, v), for poses
    [..., 7]."""
    cam = cfg.camera
    w_d = cfg.tracker.depth_weight
    xc = se3.pose_apply(pose_cw[..., None, :], pts_w)
    uv_pred = cam_mod.project(cam, xc)
    r_uv = uv_pred - uv_obs
    r_z = torch.where(has_depth, w_d * (xc[..., 2] - depth_obs), 0.0)
    r = torch.cat([r_uv, r_z[..., None]], dim=-1)

    # d xc / d xi = [-hat(xc) | I]  (left perturbation)
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(xc.shape[:-1] + (3, 3))
    dxc = torch.cat([-se3.hat(xc), eye], dim=-1)  # [..., N, 3, 6]
    J_uv = cam_mod.project_jacobian(cam, xc) @ dxc  # [..., N, 2, 6]
    J_z = w_d * dxc[..., 2:3, :]  # [..., N, 1, 6]
    J_z = torch.where(has_depth[..., None, None], J_z, 0.0)
    J = torch.cat([J_uv, J_z], dim=-2)
    behind = xc[..., 2] <= 1e-3
    return (torch.where(behind[..., None], 0.0, r),
            torch.where(behind[..., None, None], 0.0, J))


def optimize_pose(
    cfg: SlamConfig,
    pose0,
    pts_w,
    uv_obs,
    depth_obs,
    has_depth,
    obs_mask,
    octave=None,
    inliers0=None,
) -> PoseOptResult:
    """Robust GN pose refinement with chi2 outlier gating
    (``optimize_pose_plain``'s contract): for CUDA tensors ONE launch of the
    ``pose_gn`` kernel (``ops.pose_cuda.pose_gn``), for CPU tensors
    ``optimize_pose_plain``."""
    if pts_w.device.type == "cuda":
        return PoseOptResult(*pose_cuda.pose_gn(
            cfg, pose0, pts_w, uv_obs, depth_obs, has_depth, obs_mask,
            octave, inliers0))
    return optimize_pose_plain(cfg, pose0, pts_w, uv_obs, depth_obs,
                               has_depth, obs_mask, octave, inliers0)


def optimize_pose_plain(
    cfg: SlamConfig,
    pose0,
    pts_w,
    uv_obs,
    depth_obs,
    has_depth,
    obs_mask,
    octave=None,
    inliers0=None,
) -> PoseOptResult:
    """Robust GN pose refinement with chi2 outlier gating.

    Runs ``ba_rounds`` outer rounds; each does ``ba_iters`` damped GN steps
    on the current inliers, then reclassifies inliers at the chi2 bound (2
    dof for mono edges, 3 dof for depth edges).  ``inliers0`` optionally
    seeds the first round's inlier set.  ``pose0`` may carry leading batch
    dims ([..., 7], with ``pts_w`` and the masks [..., N]): each pose is
    refined on its own, as the reference's ``vmap`` over candidates does.
    """
    tk = cfg.tracker
    n = pts_w.shape[-2]
    if octave is None:
        octave = torch.zeros((n,), dtype=torch.int32, device=pts_w.device)
    info = robust.octave_inv_sigma2(octave, cfg.orb.scale_factor)
    eye6 = torch.eye(6, dtype=pts_w.dtype, device=pts_w.device)

    def edge_chi2(pose):
        r, _ = pose_residuals(cfg, pose, pts_w, uv_obs, depth_obs, has_depth)
        return torch.sum(r * r, dim=-1) * info

    pose = pose0
    inlier = (obs_mask if inliers0 is None else inliers0).to(torch.float32)
    for _ in range(tk.ba_rounds):
        poses_hist, costs_hist = [], []
        p = pose
        for _ in range(tk.ba_iters):
            r, J = pose_residuals(cfg, p, pts_w, uv_obs, depth_obs, has_depth)
            chi2 = torch.sum(r * r, dim=-1) * info
            cost = torch.sum(robust.huber_cost(chi2, tk.huber_delta) * inlier, dim=-1)
            w = robust.huber_weight(chi2, tk.huber_delta) * info * inlier
            Jw = J * w[..., None, None]
            H = torch.einsum("...nri,...nrj->...ij", Jw, J)
            b = -torch.einsum("...nri,...nr->...i", Jw, r)
            trace = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
            H = H + 1e-5 * eye6 * (1.0 + trace[..., None, None] / 6.0)
            xi = robust.cho_solve(H, b)
            xi = torch.where(torch.all(torch.isfinite(xi), dim=-1, keepdim=True),
                             xi, 0.0)
            poses_hist.append(p)
            costs_hist.append(cost)
            p = se3.retract(p, xi)
        # Pick the iterate with the lowest observed cost; the final proposal
        # wins if it is no worse.
        costs = torch.stack(costs_hist)                       # [iters, ...]
        best = torch.argmin(costs, dim=0, keepdim=True)       # [1, ...]
        pose = torch.gather(torch.stack(poses_hist), 0,
                            best[..., None].expand((1,) + p.shape))[0]
        best_cost = torch.gather(costs, 0, best)[0]
        final_cost = torch.sum(
            robust.huber_cost(edge_chi2(p), tk.huber_delta) * inlier, dim=-1
        )
        pose = torch.where((final_cost <= best_cost)[..., None], p, pose)
        chi2 = edge_chi2(pose)
        bound = torch.where(has_depth, tk.chi2_3d, tk.chi2_2d)
        inlier = obs_mask.to(torch.float32) * (chi2 < bound)

    chi2 = edge_chi2(pose)
    cost = torch.sum(robust.huber_cost(chi2, tk.huber_delta) * inlier, dim=-1)
    return PoseOptResult(
        pose=pose,
        inliers=inlier > 0.5,
        n_inliers=torch.sum(inlier > 0.5, dim=-1).to(torch.int32),
        chi2=cost,
    )
