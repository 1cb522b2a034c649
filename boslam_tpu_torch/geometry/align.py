"""Trajectory alignment + ATE evaluation on torch tensors.

Horn/Umeyama closed-form SE(3)/Sim(3) alignment and the TUM-style absolute
trajectory error: align the estimate to groundtruth, then the RMSE of the
translational residuals.
"""

from __future__ import annotations

import torch

from boslam_tpu_torch.geometry import se3


def umeyama(src, dst, weights=None, with_scale: bool = False):
    """Least-squares similarity transform aligning ``src`` onto ``dst``.

    Args:
      src, dst: [N, 3] corresponding points.
      weights: optional [N] nonnegative weights (mask-friendly).
      with_scale: solve for scale (Sim3) or fix s=1 (SE3; RGBD case).

    Returns:
      (scale, q[4], t[3]) with dst ≈ s * R(q) src + t.
    """
    if weights is None:
        weights = torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    mu_s = torch.sum(w[:, None] * src, dim=0)
    mu_d = torch.sum(w[:, None] * dst, dim=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = (dc * w[:, None]).T @ sc  # [3, 3], dst-rows x src-cols
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = U @ D @ Vt
    var_s = torch.sum(w * torch.sum(sc * sc, dim=-1))
    if with_scale:
        s = torch.sum(S * torch.diagonal(D)) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - s * R @ mu_s
    return s, se3.mat_to_quat(R), t


def ate_rmse(est_t, gt_t, weights=None, with_scale: bool = False):
    """Absolute trajectory error RMSE after Umeyama alignment.

    Args:
      est_t: [N, 3] estimated positions (camera centres, world frame).
      gt_t: [N, 3] groundtruth positions (time-associated).

    Returns:
      (rmse, aligned_est[N, 3])
    """
    if weights is None:
        weights = torch.ones(est_t.shape[0], dtype=est_t.dtype,
                             device=est_t.device)
    s, q, t = umeyama(est_t, gt_t, weights, with_scale)
    aligned = s * se3.quat_rotate(q[None, :], est_t) + t
    err2 = torch.sum((aligned - gt_t) ** 2, dim=-1)
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    return torch.sqrt(torch.sum(w * err2)), aligned


def rpe(est_poses, gt_poses, delta: int = 1):
    """Relative pose error over a fixed frame delta.

    Args:
      est_poses, gt_poses: [N, 7] world-frame poses (T_wc).

    Returns:
      (trans_rmse, rot_rmse_rad)
    """
    e0, e1 = est_poses[:-delta], est_poses[delta:]
    g0, g1 = gt_poses[:-delta], gt_poses[delta:]
    de = se3.pose_compose(se3.pose_inv(e0), e1)
    dg = se3.pose_compose(se3.pose_inv(g0), g1)
    err = se3.pose_compose(se3.pose_inv(dg), de)
    dt = torch.linalg.vector_norm(err[..., 4:], dim=-1)
    dr = torch.linalg.vector_norm(se3.so3_log(err[..., :4]), dim=-1)
    return torch.sqrt(torch.mean(dt**2)), torch.sqrt(torch.mean(dr**2))
