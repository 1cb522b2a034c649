"""Relocalization's whole-map match and the error of a recovered camera
centre, in plain PyTorch.

The match is the program's rule (``boslam_tpu_torch/matching/hamming.py``
``match_top2``, ``matching/rotation.py`` ``rotation_consistency`` and
``tracking/tracker.py`` ``_global_candidates``, at commit 37f0a60) written
again from its statement: the 256-bit Hamming distance of each frame row
to each admissible map column by popcount of the XOR; per row the best
column (ties to the lower column) and the second-best distance over the
other columns; a row matches when it is valid, its best distance is at
most ``max_dist`` and, in float32, at most ``ratio`` times the second; with
``mutual`` the best column's own best valid row (ties to the lower row) has
to be the row.  Rotation consistency then keeps, where at least 12 rows
match, the matches whose keypoint-angle difference falls in the three
fullest of 30 bins.  RANSAC's draws come from the engine's generator, so
what follows the match is judged by its outcome: the recovered camera
centre against the ground truth (``centre_errors``), and the refine by
its objective (``refine_gap``): motion-only BA's robust cost as
``solvers/pose_opt.py`` states it (per matched keypoint the residual
``[u - u_obs, v - v_obs, w_d (z - z_obs)]``, the depth row where the
keypoint has depth, chi2 = |r|^2 scale^(-2 octave), the Huber cost of chi2
over the edges under their chi2 bound) at the program's pose against its
minimum from there, found in float64.  Nothing here imports the port.
"""

from __future__ import annotations

import torch

from reference import ba as ref_ba
from reference.geometry import ate_rmse, retract

BIG = 1 << 20          # the distance of an inadmissible pair
TWO_PI = 6.283185307179586
N_BINS, KEEP_TOP, MIN_MATCHES = 30, 3, 12
COLS = 2048            # map columns per popcount block


def popcount32(x):
    """Set bits of each 32-bit word held in an int32 or int64 tensor."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming(desc_a, desc_b):
    """[N, 8] x [M, 8] int32 descriptor words -> [N, M] int32 distances."""
    out = torch.empty((desc_a.shape[0], desc_b.shape[0]), dtype=torch.int32,
                      device=desc_a.device)
    for c in range(0, desc_b.shape[0], COLS):
        x = desc_a[:, None, :] ^ desc_b[None, c:c + COLS, :]
        out[:, c:c + COLS] = popcount32(x).sum(-1).to(torch.int32)
    return out


def match(desc_a, uv_a, r_a, valid_a, desc_b, uv_b, vis_b, max_dist: int,
          ratio: float, mutual: bool):
    """The window match of ``fused_match_top2``'s arguments: (idx [N] int32
    into the map or -1, ok [N] bool).  Only the admissible columns (visible,
    and inside a finite window) are computed; they keep their order, so a
    tie goes to the lower column as over the whole map."""
    n = desc_a.shape[0]
    dev = desc_a.device
    cols = torch.nonzero(vis_b)[:, 0]
    if cols.numel() == 0:
        return (torch.full((n,), -1, dtype=torch.int32, device=dev),
                torch.zeros((n,), dtype=torch.bool, device=dev))
    dist = hamming(desc_a, desc_b[cols])
    d2 = torch.sum((uv_a[:, None, :] - uv_b[cols][None, :, :]) ** 2, -1)
    big = torch.full((), BIG, dtype=torch.int32, device=dev)
    masked = torch.where(d2 <= r_a[:, None] ** 2, dist, big)
    best, j = torch.min(masked, dim=1)  # the first minimum
    rest = masked.clone()
    rest[torch.arange(n, device=dev), j] = BIG
    second = rest.min(dim=1).values
    ok = valid_a & (best <= max_dist) & (
        best.to(torch.float32)
        <= torch.tensor(ratio, dtype=torch.float32) * second.to(torch.float32))
    if mutual:
        by_col = torch.where(valid_a[:, None], masked, big)
        col_best = torch.min(by_col, dim=0).indices
        ok &= col_best[j] == torch.arange(n, device=dev)
    idx = torch.where(ok, cols[j], -1).to(torch.int32)
    return idx, ok


def rotation_filter(angle_a, angle_b, ok):
    """The matches in the three fullest of 30 bins of angle difference, all
    of them below 12 matches."""
    rot = torch.fmod(angle_a - angle_b, TWO_PI)
    rot = torch.where((rot != 0) & (rot < 0), rot + TWO_PI, rot)
    b = torch.clamp((rot / (TWO_PI / N_BINS)).to(torch.int32), 0,
                    N_BINS - 1).long()
    hist = torch.bincount(b[ok], minlength=N_BINS).to(torch.float32)
    thresh = torch.clamp(torch.sort(hist).values[-KEEP_TOP], min=1.0)
    keep = ok & (hist >= thresh)[b]
    return keep if int(ok.sum()) >= MIN_MATCHES else ok


def whole_map(desc, valid, has_depth, angle, pt_desc, pt_valid, pt_angle,
              max_dist: int, ratio: float = 0.85):
    """Relocalization's match of a frame against every live map point: the
    depth-backed frame rows, no window, mutual, then rotation consistency.
    (idx [N] int32 or -1, ok [N] bool)."""
    n = desc.shape[0]
    inf = torch.full((n,), float("inf"), device=desc.device)
    zeros = torch.zeros((pt_desc.shape[0], 2), device=desc.device)
    idx, ok = match(desc, torch.zeros((n, 2), device=desc.device), inf,
                    valid & has_depth, pt_desc, zeros, pt_valid, max_dist,
                    ratio, True)
    ok = rotation_filter(angle, pt_angle[idx.clamp(min=0).long()], ok)
    return torch.where(ok, idx, -1), ok


def row_mismatch(idx, ok, ref_idx, ref_ok) -> float:
    """The share of rows whose (index, match) differ."""
    differ = (ok != ref_ok) | (ok & (idx != ref_idx))
    return float(differ.to(torch.float64).mean())


def centre_errors(est_xyz, gt_xyz, posed, at):
    """The camera centres ``est_xyz[at]`` against ``gt_xyz[at]`` after the
    rigid float64 alignment of the ``posed`` rows (numpy [T, 3], [T] bool):
    (the alignment's RMSE, the errors at ``at`` in metres)."""
    rmse, R, t = ate_rmse(est_xyz[posed], gt_xyz[posed])
    est = torch.as_tensor(est_xyz[at], dtype=torch.float64)
    gt = torch.as_tensor(gt_xyz[at], dtype=torch.float64)
    err = torch.linalg.vector_norm(est @ R.T + t - gt, dim=-1)
    return rmse, err.tolist()


def _objective(cam, pose, pts, e):
    r = ref_ba.residuals(cam, pose[None], pts, e)
    return torch.sum(ref_ba.huber_cost(torch.sum(r * r, -1) * e.info,
                                       cam.huber_delta))


def refine_gap(slam_cfg: dict, pose, pts_w, uv, depth, has_depth, ok, octave,
               iters: int = 30):
    """(f(pose) - f*) / f*, in float64: f is the robust cost over the
    matched keypoints (``ok``) that are under their chi2 bound at ``pose``,
    f* its minimum from ``pose`` by damped Gauss-Newton (a step is taken
    where it lowers f, else the damping grows)."""
    f64 = torch.float64
    tk = slam_cfg["tracker"]
    c = slam_cfg["camera"]
    cam = ref_ba.Camera(c["fx"], c["fy"], c["cx"], c["cy"],
                        tk["depth_weight"], tk["huber_delta"])
    rows = torch.nonzero(ok)[:, 0]
    hd = (has_depth & ok)[rows]
    n = rows.shape[0]
    e = ref_ba.Edges(
        cam=torch.zeros(n, dtype=torch.long, device=pose.device),
        pt=torch.arange(n, device=pose.device), uv=uv[rows].to(f64),
        depth=depth[rows].to(f64), has_depth=hd,
        info=torch.pow(float(slam_cfg["orb"]["scale_factor"]),
                       -2.0 * octave[rows].to(f64)))
    pts = pts_w[rows].to(f64)
    p = pose.to(f64)
    r = ref_ba.residuals(cam, p[None], pts, e)
    bound = torch.where(hd, tk["chi2_3d"], tk["chi2_2d"])
    keep = torch.sum(r * r, -1) * e.info < bound
    pts = pts[keep]
    e = ref_ba.Edges(*(a[keep] for a in e))._replace(
        pt=torch.arange(pts.shape[0], device=pose.device))
    f0 = f = _objective(cam, p, pts, e)
    lam = 1e-6
    for _ in range(iters):
        r, Jc, _ = ref_ba.residuals(cam, p[None], pts, e, jacobians=True)
        chi2 = torch.sum(r * r, -1) * e.info
        err = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w = torch.where(err <= cam.huber_delta, 1.0,
                        cam.huber_delta / err) * e.info
        H = torch.einsum("eri,e,erj->ij", Jc, w, Jc)
        b = -torch.einsum("eri,e,er->i", Jc, w, r)
        H = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-9))
        trial = retract(p, torch.linalg.solve(H, b))
        f_trial = _objective(cam, trial, pts, e)
        if f_trial < f:
            p, f, lam = trial, f_trial, lam * 0.1
        else:
            lam *= 10.0
    return float((f0 - f) / f), int(keep.sum())
