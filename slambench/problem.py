"""The synthetic global-BA problem: keyframes on a ring looking out at
landmarks in a box, every keyframe observing a fixed number of them, then
poses and points perturbed.

Frozen copy of ``boslam_tpu_torch/io/synthetic.py:synthetic_ba_problem`` at
commit bd2752c, in numpy, with one change: the draws that fix the
problem's structure (the landmarks and which keyframe observes which)
come from ``structure_seed`` and the noise (pixels, depths, the
perturbation of points and poses) from the run's seed, so that every seed
gives a problem of the same edges and landmarks.  Nothing imports the port.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.geometry import exp, quat_to_mat, retract


def make(spec: dict, slam_cfg: dict, seed: int) -> dict:
    """The map arrays (numpy) of the problem ``spec`` (``n_kf``, ``n_pts``,
    ``obs_per_kf``, ``structure_seed``, noise levels) at the capacities of
    ``slam_cfg``; ``gt_poses`` [n_kf, 7] T_cw and ``gt_pts`` beside them."""
    cam = slam_cfg["camera"]
    K = slam_cfg["map"]["max_keyframes"]
    P = slam_cfg["map"]["max_points"]
    N = slam_cfg["orb"]["n_features"]
    n_kf, n_pts, obs_per_kf = spec["n_kf"], spec["n_pts"], spec["obs_per_kf"]
    if not (n_kf <= K and n_pts <= P and obs_per_kf <= N):
        raise ValueError("the problem does not fit the map's capacities")
    rs = np.random.default_rng(spec["structure_seed"])
    rn = np.random.default_rng(seed)

    pts = np.stack([rs.uniform(-6.0, 6.0, n_pts), rs.uniform(-2.5, 2.5, n_pts),
                    rs.uniform(-6.0, 6.0, n_pts)], -1).astype(np.float32)
    a = 2 * np.pi * np.arange(n_kf) / n_kf
    xi = np.stack([np.zeros(n_kf), a, np.zeros(n_kf), 0.4 * np.cos(a),
                   np.zeros(n_kf), 0.4 * np.sin(a)], -1)
    gt_poses = exp(torch.from_numpy(xi)).numpy().astype(np.float32)

    kf_pose = np.zeros((K, 7), np.float32)
    kf_pose[:, 0] = 1.0
    kf_uv = np.zeros((K, N, 2), np.float32)
    kf_depth = np.zeros((K, N), np.float32)
    kf_obs = np.full((K, N), -1, np.int32)
    kf_kpv = np.zeros((K, N), bool)
    kf_valid = np.zeros(K, bool)
    obs_count = np.zeros(n_pts, np.int64)
    R_all = quat_to_mat(torch.from_numpy(gt_poses[:, :4])).numpy()
    xc_all = np.einsum("kij,pj->kpi", R_all, pts) + gt_poses[:, None, 4:]
    z_all = xc_all[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u_all = cam["fx"] * xc_all[..., 0] / z_all + cam["cx"]
        v_all = cam["fy"] * xc_all[..., 1] / z_all + cam["cy"]
    vis_all = ((z_all > cam["depth_min"]) & (z_all < cam["depth_max"])
               & (u_all >= 1) & (u_all < cam["width"] - 1)
               & (v_all >= 1) & (v_all < cam["height"] - 1))
    px_noise = spec["px_noise"]
    for k in range(n_kf):
        cand = np.where(vis_all[k])[0]
        # Under-observed points first, so that coverage stays even.
        order = np.argsort(obs_count[cand] + rs.uniform(0, 0.5, len(cand)))
        take = cand[order[:obs_per_kf]]
        obs_count[take] += 1
        s = len(take)
        kf_pose[k] = gt_poses[k]
        kf_uv[k, :s] = (np.stack([u_all[k], v_all[k]], -1)[take]
                        + rn.normal(0, px_noise, (s, 2)))
        kf_depth[k, :s] = xc_all[k, take, 2] * (1 + rn.normal(0, spec["depth_noise"], s))
        kf_obs[k, :s] = take
        kf_kpv[k, :s] = True
        kf_valid[k] = True

    seen = obs_count >= 2  # a point seen once constrains nothing
    kf_obs = np.where((kf_obs >= 0) & seen[np.clip(kf_obs, 0, n_pts - 1)],
                      kf_obs, -1).astype(np.int32)
    pt_xyz = np.zeros((P, 3), np.float32)
    pt_valid = np.zeros(P, bool)
    pt_xyz[:n_pts] = pts + rn.normal(0, spec["pt_noise"], pts.shape)
    pt_valid[:n_pts] = seen
    noise = rn.normal(0, spec["pose_noise"], (n_kf - 1, 6))
    kf_pose[1:n_kf] = retract(torch.from_numpy(kf_pose[1:n_kf].astype(np.float64)),
                              torch.from_numpy(noise)).numpy()
    return dict(kf_pose=kf_pose, kf_uv=kf_uv, kf_depth=kf_depth,
                kf_obs=kf_obs, kf_kpv=kf_kpv, kf_valid=kf_valid,
                kf_octave=np.zeros((K, N), np.int32),
                kf_seq=np.where(kf_valid, np.arange(K), -1).astype(np.int32),
                n_kf=n_kf, pt_xyz=pt_xyz, pt_valid=pt_valid,
                gt_poses=gt_poses, gt_pts=pts)
