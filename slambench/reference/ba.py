"""Bundle adjustment in plain PyTorch: the robust objective of the engine's
global BA and a Levenberg-Marquardt solve with an exact Schur complement.

The objective is the one ``boslam_tpu_torch/solvers/ba_core.py`` and
``global_ba.py`` state at commit bd2752c: per observation of point p in
keyframe k the residual ``[u - u_obs, v - v_obs, w_d (z - z_obs)]`` (the
depth row only where the observation has depth; zero for a point at
z <= 1e-3), chi2 = |r|^2 * scale^(-2 octave), the Huber cost of chi2 with
``local_ba.huber_delta`` summed, keyframe 0 held fixed.  The LM schedule
is the engine's (lambda from 1e-4, halved on a decrease and quadrupled
otherwise, damping lambda * diag(max(diag H, 1e-6)) plus 1e-7 on the
cameras and 1e-8 on the points); the step solves the reduced camera
system exactly (LU) instead of by preconditioned CG.  Local BA's damped
Gauss-Newton (``solvers/local_ba.py``: a fixed lambda schedule, every
step taken, the damping on the reduced system's diagonal) shares the
step.  Written from
that description; nothing imports the port.  Every tensor takes the dtype
of the inputs, so the same code runs in float64 (the reference) and in
float32; with ``tf32`` every matrix product rounds its operands to TF32
(the control).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference.geometry import hat, mm, quat_to_mat, retract, rotate


class Edges(NamedTuple):
    cam: torch.Tensor        # [E] long
    pt: torch.Tensor         # [E] long
    uv: torch.Tensor         # [E, 2]
    depth: torch.Tensor      # [E]
    has_depth: torch.Tensor  # [E] bool
    info: torch.Tensor       # [E]


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    depth_weight: float
    huber_delta: float


def camera(slam_cfg: dict) -> Camera:
    c = slam_cfg["camera"]
    return Camera(c["fx"], c["fy"], c["cx"], c["cy"],
                  slam_cfg["tracker"]["depth_weight"],
                  slam_cfg["local_ba"]["huber_delta"])


def edges_from_map(raw: dict, scale_factor: float, dtype, device) -> Edges:
    """Every observation ``kf_obs[k, s] >= 0`` of a valid keyframe, a valid
    keypoint and a valid point is an edge."""
    obs = torch.as_tensor(raw["kf_obs"]).long()
    pt_valid = torch.as_tensor(raw["pt_valid"])
    ok = ((obs >= 0) & torch.as_tensor(raw["kf_valid"])[:, None]
          & torch.as_tensor(raw["kf_kpv"])
          & pt_valid[obs.clamp(min=0)])
    k_idx, s_idx = torch.nonzero(ok, as_tuple=True)
    depth = torch.as_tensor(raw["kf_depth"])[k_idx, s_idx].to(dtype)
    octave = torch.as_tensor(raw["kf_octave"])[k_idx, s_idx].to(dtype)
    return Edges(
        cam=k_idx.to(device), pt=obs[k_idx, s_idx].to(device),
        uv=torch.as_tensor(raw["kf_uv"])[k_idx, s_idx].to(dtype).to(device),
        depth=depth.to(device), has_depth=(depth > 0).to(device),
        info=torch.pow(torch.tensor(scale_factor, dtype=dtype),
                       -2.0 * octave).to(device))


def residuals(cam: Camera, poses, pts, e: Edges, jacobians: bool = False,
              tf32: bool = False):
    """r [E, 3] and, with ``jacobians``, d r / d (camera twist) [E, 3, 6]
    and d r / d point [E, 3, 3]."""
    pose = poses[e.cam]
    R = quat_to_mat(pose[:, :4])
    xc = rotate(R, pts[e.pt], tf32) + pose[:, 4:]
    x, y, z = xc.unbind(-1)
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    r = torch.stack([cam.fx * x / zs + cam.cx - e.uv[:, 0],
                     cam.fy * y / zs + cam.cy - e.uv[:, 1],
                     torch.where(e.has_depth, cam.depth_weight * (z - e.depth),
                                 0.0)], -1)
    bad = z <= 1e-3
    r = torch.where(bad[:, None], 0.0, r)
    if not jacobians:
        return r
    iz = 1.0 / zs
    zero = torch.zeros_like(x)
    Jp2 = torch.stack([torch.stack([cam.fx * iz, zero, -cam.fx * x * iz * iz], -1),
                       torch.stack([zero, cam.fy * iz, -cam.fy * y * iz * iz], -1)],
                      -2)                                       # [E, 2, 3]
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(xc.shape[0], 3, 3)
    dxc = torch.cat([-hat(xc), eye], -1)                        # [E, 3, 6]
    zrow = e.has_depth[:, None, None]
    Jc = torch.cat([mm(Jp2, dxc, tf32),
                    torch.where(zrow, cam.depth_weight * dxc[:, 2:3], 0.0)], -2)
    Jp = torch.cat([mm(Jp2, R, tf32),
                    torch.where(zrow, cam.depth_weight * R[:, 2:3], 0.0)], -2)
    Jc = torch.where(bad[:, None, None], 0.0, Jc)
    Jp = torch.where(bad[:, None, None], 0.0, Jp)
    return r, Jc, Jp


def _chi2(r, e: Edges):
    return torch.sum(r * r, -1) * e.info


def huber_cost(chi2, delta: float):
    err = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(err <= delta, 0.5 * chi2, delta * (err - 0.5 * delta))


def cost(cam: Camera, poses, pts, e: Edges, tf32: bool = False):
    """The objective: the sum of the edges' Huber costs."""
    r = residuals(cam, poses, pts, e, tf32=tf32)
    return torch.sum(huber_cost(_chi2(r, e), cam.huber_delta))


def _damp(H, lam, eps):
    d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-6)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + lam * torch.diag_embed(d) + eps * eye


def _pairs(pt_sorted):
    """(a, b) index pairs of every two edges (in sorted order) that observe
    the same point, the edge with itself included."""
    n = pt_sorted.shape[0]
    dev = pt_sorted.device
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = pt_sorted[1:] != pt_sorted[:-1]
    seg = torch.cumsum(first.long(), 0) - 1
    starts = torch.nonzero(first)[:, 0]
    lens = torch.bincount(seg)
    reps = lens[seg]
    a = torch.repeat_interleave(torch.arange(n, device=dev), reps)
    excl = torch.cumsum(reps, 0) - reps
    b = starts[seg][a] + (torch.arange(a.shape[0], device=dev) - excl[a])
    return a, b


def _schur_step(cam: Camera, poses, pts, e: Edges, opt_cams, pairs, lam,
                damp: str, tf32: bool = False):
    """One damped Gauss-Newton step (dx [K, 6], zero off ``opt_cams``; dpt
    [P, 3]) with the reduced camera system solved exactly (LU: in float32
    it can lose its definiteness).  ``damp`` "cameras" damps each camera
    block before the reduction (global BA); "schur" damps the reduced
    system's diagonal (local BA).  The points' blocks are damped either
    way."""
    K, P = poses.shape[0], pts.shape[0]
    dtype, dev = poses.dtype, poses.device
    pair_a, pair_b = pairs
    opt_idx = torch.nonzero(opt_cams)[:, 0]
    r, Jc, Jp = residuals(cam, poses, pts, e, True, tf32)
    chi2 = _chi2(r, e)
    err = torch.sqrt(torch.clamp(chi2, min=1e-12))
    w = torch.where(err <= cam.huber_delta, 1.0,
                    cam.huber_delta / err) * e.info
    Jc = torch.where(opt_cams[e.cam][:, None, None], Jc, 0.0)
    WJc, WJp = w[:, None, None] * Jc, w[:, None, None] * Jp
    Hcc = torch.zeros(K, 6, 6, dtype=dtype, device=dev).index_add_(
        0, e.cam, mm(Jc.transpose(1, 2), WJc, tf32))
    bc = -torch.zeros(K, 6, dtype=dtype, device=dev).index_add_(
        0, e.cam, mm(Jc.transpose(1, 2), (w[:, None] * r)[..., None], tf32)[..., 0])
    Hpp = torch.zeros(P, 3, 3, dtype=dtype, device=dev).index_add_(
        0, e.pt, mm(Jp.transpose(1, 2), WJp, tf32))
    bp = -torch.zeros(P, 3, dtype=dtype, device=dev).index_add_(
        0, e.pt, mm(Jp.transpose(1, 2), (w[:, None] * r)[..., None], tf32)[..., 0])
    Hcp = mm(Jc.transpose(1, 2), WJp, tf32)                     # [E, 6, 3]
    Hpp_inv = torch.linalg.inv(_damp(Hpp, lam, 1e-8))
    Y = mm(Hcp, Hpp_inv[e.pt], tf32)                            # [E, 6, 3]
    S = torch.zeros(K * K, 6, 6, dtype=dtype, device=dev).index_add_(
        0, e.cam[pair_a] * K + e.cam[pair_b],
        mm(Y[pair_a], Hcp[pair_b].transpose(1, 2), tf32))
    S = -S.reshape(K, K, 6, 6)
    S[torch.arange(K), torch.arange(K)] += (
        _damp(Hcc, lam, 1e-7) if damp == "cameras" else Hcc)
    b = bc - torch.zeros(K, 6, dtype=dtype, device=dev).index_add_(
        0, e.cam, mm(Y, bp[e.pt][..., None], tf32)[..., 0])
    So = S[opt_idx][:, opt_idx].permute(0, 2, 1, 3).reshape(
        6 * len(opt_idx), 6 * len(opt_idx))
    if damp == "schur":
        So = _damp(So, lam, 1e-7)
    dx_o = torch.linalg.solve(So, b[opt_idx].reshape(-1, 1)).reshape(-1, 6)
    dx = torch.zeros(K, 6, dtype=dtype, device=dev)
    dx[opt_idx] = dx_o
    t = torch.zeros(P, 3, dtype=dtype, device=dev).index_add_(
        0, e.pt, mm(Hcp.transpose(1, 2), dx[e.cam][..., None], tf32)[..., 0])
    dpt = mm(Hpp_inv, (bp - t)[..., None], tf32)[..., 0]
    return dx, dpt


def _point_pairs(e: Edges):
    order = torch.argsort(e.pt, stable=True)
    pair_a, pair_b = _pairs(e.pt[order])
    return order[pair_a], order[pair_b]


def levenberg_marquardt(cam: Camera, poses, pts, e: Edges, opt_cams,
                        lm_iters: int, tf32: bool = False):
    """``lm_iters`` LM iterations; ``opt_cams`` [K] bool marks the cameras
    that move (the others, keyframe 0 among them, stay).  Returns (poses,
    points, cost before, cost after), the costs in the inputs' dtype."""
    pairs = _point_pairs(e)
    lam = torch.tensor(1e-4, dtype=poses.dtype, device=poses.device)
    cur = cost(cam, poses, pts, e, tf32)
    cost0 = cur
    for _ in range(lm_iters):
        dx, dpt = _schur_step(cam, poses, pts, e, opt_cams, pairs, lam,
                              "cameras", tf32)
        new_poses = torch.where(opt_cams[:, None], retract(poses, dx, tf32),
                                poses)
        new_pts = pts + dpt
        new = cost(cam, new_poses, new_pts, e, tf32)
        accept = new < cur
        poses = torch.where(accept, new_poses, poses)
        pts = torch.where(accept, new_pts, pts)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e3)
        cur = torch.minimum(new, cur)
    return poses, pts, cost0, cur


def damped_gauss_newton(cam: Camera, poses, pts, e: Edges, opt_cams, lams,
                        tf32: bool = False):
    """Local BA's schedule: one step per entry of ``lams``, every step
    taken, the reduced system damped on its diagonal; a step that is not
    finite is skipped.  Returns (poses, points, cost before, cost after)."""
    pairs = _point_pairs(e)
    cost0 = cost(cam, poses, pts, e, tf32)
    for lam in lams:
        dx, dpt = _schur_step(cam, poses, pts, e, opt_cams, pairs, lam,
                              "schur", tf32)
        if not (torch.isfinite(dx).all() and torch.isfinite(dpt).all()):
            continue
        poses = torch.where(opt_cams[:, None], retract(poses, dx, tf32), poses)
        pts = pts + dpt
    return poses, pts, cost0, cost(cam, poses, pts, e, tf32)


def local_window(raw: dict, center: int, lb: dict, scale_factor: float,
                 dtype, device):
    """Local BA's problem around keyframe ``center``, worked out again from
    a map's arrays (``solvers/local_ba.py`` at commit bd2752c): the center
    and its ``n_opt_kf - 1`` most covisible keyframes move (keyframe 0
    never does), the ``n_fixed_kf`` keyframes most covisible with them
    stay, ties to the lower slot; the points are the first
    ``max_local_points`` valid points (by slot) that a moving keyframe
    observes; one edge per (keyframe, point), from the keyframe's last
    keypoint slot that observes it.  Returns (keyframe slots [C], which of
    them move [C] bool, point slots [L], Edges over those indices)."""
    covis = raw["covis"].astype(np.int64)
    kf_valid = raw["kf_valid"].astype(bool)
    K = covis.shape[0]
    row = covis[center] * kf_valid
    row[center] = 0
    near = np.argsort(-row, kind="stable")[:lb["n_opt_kf"] - 1]
    opt = np.concatenate([[center], near[row[near] > 0]])
    opt = opt[kf_valid[opt]]
    ring = covis[opt].sum(0) * kf_valid
    ring[opt] = 0
    ring[center] = 0
    ring_ids = np.argsort(-ring, kind="stable")[:lb["n_fixed_kf"]]
    fix = ring_ids[ring[ring_ids] > 0]
    cams = np.concatenate([opt, fix])
    moves = np.concatenate([opt != 0, np.zeros(len(fix), bool)])

    obs = raw["kf_obs"].astype(np.int64)
    pt_valid = raw["pt_valid"].astype(bool)
    P = pt_valid.shape[0]
    seen = np.zeros(P, bool)
    o = obs[opt]
    seen[o[o >= 0]] = True
    pt_ids = np.nonzero(seen & pt_valid)[0][:lb["max_local_points"]]
    local = np.full(P, -1)
    local[pt_ids] = np.arange(len(pt_ids))

    o = obs[cams]
    pl = local[np.clip(o, 0, P - 1)]
    ok = (o >= 0) & (pl >= 0) & raw["kf_kpv"][cams].astype(bool)
    c_idx, s_idx = np.nonzero(ok)
    # A point that one keyframe observes twice keeps the last slot.
    key = c_idx * len(pt_ids) + pl[c_idx, s_idx]
    last = np.ones(len(key), bool)
    order = np.lexsort((s_idx, key))
    last[order[:-1]] = key[order[:-1]] != key[order[1:]]
    c_idx, s_idx = c_idx[last], s_idx[last]
    kf = cams[c_idx]

    def take(name):
        return torch.as_tensor(raw[name][kf, s_idx]).to(device, dtype)

    depth = take("kf_depth")
    e = Edges(cam=torch.as_tensor(c_idx).to(device),
              pt=torch.as_tensor(pl[c_idx, s_idx]).to(device),
              uv=take("kf_uv"), depth=depth, has_depth=depth > 0,
              info=torch.pow(torch.tensor(scale_factor, dtype=dtype),
                             -2.0 * take("kf_octave")).to(device))
    return cams, torch.as_tensor(moves).to(device), pt_ids, e
