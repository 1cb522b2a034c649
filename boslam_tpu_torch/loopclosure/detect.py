"""Loop detection: BoW candidate retrieval, temporal consistency, geometric
verification (``boslam_tpu.loopclosure.detect``).

Candidate scoring is a dense BoW product over all keyframes with masks for
covisible neighbors and recency; the covisibility-neighborhood minimum
score is the adaptive baseline.  Verification is descriptor matching + 3D-3D
SE3 RANSAC on keypoint backprojections, then pixel GN; the reference's
``vmap`` over requests is a batch dimension here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.geometry import camera as cam_mod
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.loopclosure.vocab import LoopState
from boslam_tpu_torch.matching import hamming
from boslam_tpu_torch.matching.rotation import rotation_consistency
from boslam_tpu_torch.solvers.pose_opt import optimize_pose
from boslam_tpu_torch.solvers.ransac import ransac_se3
from boslam_tpu_torch.utils.tensor_ops import at, top_k


class LoopDetection(NamedTuple):
    candidate: torch.Tensor  # scalar i32 keyframe id (-1 = none)
    score: torch.Tensor      # scalar f32 BoW similarity
    consistent: torch.Tensor # scalar bool (passed temporal consistency)


def detect_loop(cfg: SlamConfig, loop: LoopState, map_state, kf_id):
    """Score keyframes against ``kf_id``; returns (LoopState, LoopDetection)."""
    lc = cfg.loop
    K = loop.kf_bow.shape[0]
    dev = loop.kf_bow.device
    scores = loop.kf_bow @ at(loop.kf_bow, kf_id)             # [K]
    neighbors = (at(map_state.covis, kf_id) >= cfg.map.covis_min_weight) \
        & map_state.kf_valid
    # Baseline: worst similarity among covisible neighbors.
    min_score = torch.min(torch.where(neighbors, scores, torch.inf))
    min_score = torch.where(torch.isfinite(min_score), min_score, 0.1)
    cand_mask = (
        map_state.kf_valid
        # Insertion-order gap, not slot-id gap: slots are free-list reused.
        & (map_state.kf_seq <= at(map_state.kf_seq, kf_id) - lc.min_gap_kf)
        & ~neighbors
        & (torch.arange(K, device=dev) != kf_id)
        & loop.vocab_ready
        & (scores >= torch.clamp_min(min_score, 0.02))
    )
    # Top-C candidates with parallel consistency streaks.
    C = loop.streak_kf.shape[0]
    svals, sidx = top_k(torch.where(cand_mask, scores, -1.0), C)
    found_c = cand_mask[sidx]                                  # [C]

    # Group of candidate c = its covisibility neighborhood (+ itself); the
    # streak continues if it overlaps ANY previous streak's group.
    def group(ids):
        return (((map_state.covis[ids] > 0) | F.one_hot(ids, K).bool())
                & map_state.kf_valid)

    g_cand = group(sidx)
    g_prev = group(torch.clamp(loop.streak_kf, 0, K - 1).long()) \
        & (loop.streak_kf >= 0)[:, None]
    overlap = torch.any(g_cand[:, None, :] & g_prev[None, :, :], dim=-1)  # [C, C]
    prev_len = torch.max(
        torch.where(overlap, loop.streak_len[None, :], 0), dim=1).values
    streak = torch.where(found_c, prev_len + 1, 0)
    new_loop = loop._replace(
        streak_kf=torch.where(found_c, sidx, -1).to(torch.int32),
        streak_len=streak.to(torch.int32),
    )

    consistent_c = found_c & (streak >= lc.consistency)
    # Report the best consistent candidate if any, else the best candidate.
    pick = torch.argmax(torch.where(consistent_c, svals, -1.0)).reshape(1)
    any_cons = consistent_c[pick][0]
    best = torch.where(any_cons, sidx[pick][0], sidx[0])
    found = any_cons | found_c[0]
    det = LoopDetection(
        candidate=torch.where(found, best, -1).to(torch.int32),
        score=at(scores, torch.clamp(best, 0, K - 1)),
        consistent=any_cons,
    )
    return new_loop, det


# Covisible neighbors pooled into loop verification (static fan-in).
VERIFY_GROUP = 4


def verify_loops_batch(cfg: SlamConfig, map_state, kf_curs, kf_cands, keys):
    """Verify a batch of loop candidates: ``kf_curs`` / ``kf_cands`` [B]
    keyframe slots, ``keys`` a ``torch.Generator`` or the RANSAC Gumbel
    noise [B, H, N].

    Geometric verification against each candidate's covisibility group:
    the current keyframe's descriptors match the stacked descriptors of the
    candidate + its top covisible neighbors, every group keypoint is
    backprojected into the candidate's camera frame through the current
    relative poses, and SE3 RANSAC + pixel-GN refinement run on the pooled
    correspondences.  The decision still requires direct current <->
    candidate overlap.

    Returns (ok [B], T_cur_cand [B, 7], n_inliers [B], idx [B, N],
    inlier_mask [B, N]); idx / inlier_mask are candidate-local keypoint
    matches (neighbor-sourced correspondences are not fused).
    """
    lc = cfg.loop
    cam = cfg.camera
    K = map_state.kf_valid.shape[0]
    G = VERIFY_GROUP
    cur = kf_curs.long()
    cand = kf_cands.long()
    B = cur.shape[0]
    d_cur = map_state.kf_desc[cur]                           # [B, N, 8]
    z_cur = map_state.kf_depth[cur]                          # [B, N]
    v_cur = map_state.kf_kp_valid[cur] & (z_cur > 0)
    N = d_cur.shape[1]

    # Group: candidate first (match indices stay candidate-local in the
    # first block), then its strongest covisible neighbors.
    w_nbr, nbr_ids = top_k(map_state.covis[cand] * map_state.kf_valid, G)
    nbr_ok = (
        (w_nbr >= cfg.map.covis_min_weight) & map_state.kf_valid[nbr_ids]
        & (nbr_ids != cur[:, None]) & (nbr_ids != cand[:, None])
    )
    gi = torch.clamp(torch.cat([cand[:, None], nbr_ids], dim=1), 0, K - 1)
    grp_ok = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=gi.device),
                        nbr_ok], dim=1)                      # [B, G+1]

    d_grp = map_state.kf_desc[gi].reshape(B, -1, 8)          # [B, (G+1)N, 8]
    z_grp = map_state.kf_depth[gi]                           # [B, G+1, N]
    v_grp = (map_state.kf_kp_valid[gi] & (z_grp > 0)
             & grp_ok[..., None]).reshape(B, -1)
    # Each group member's camera-frame points -> the candidate's frame.
    T_cand_g = se3.pose_compose(map_state.kf_pose[cand][:, None, :],
                                se3.pose_inv(map_state.kf_pose[gi]))
    x_g = cam_mod.backproject(cam, map_state.kf_uv[gi], z_grp)  # [B, G+1, N, 3]
    xc_grp = se3.pose_apply(T_cand_g[:, :, None, :], x_g).reshape(B, -1, 3)

    # Wide threshold: RANSAC gates the outliers.
    dist = hamming.hamming_matrix_mxu(d_cur, d_grp)
    idx, ok, _ = hamming.match_top2(
        dist, v_cur, v_grp, max_dist=cfg.matcher.hamming_high,
        ratio=0.9, mutual=True,
    )
    # Rotation-consistency histogram on candidate-block matches only.
    is_cand = (idx >= 0) & (idx < N)
    ang_grp = map_state.kf_angle[gi].reshape(B, -1)
    j = torch.clamp(idx, 0, (G + 1) * N - 1).long()
    ok_rot = rotation_consistency(map_state.kf_angle[cur],
                                  torch.gather(ang_grp, 1, j), ok & is_cand)
    ok = torch.where(is_cand, ok_rot, ok)
    idx = torch.where(ok, idx, -1)
    j = torch.clamp(idx, 0, (G + 1) * N - 1).long()
    uv_cur = map_state.kf_uv[cur]
    xc_cur = cam_mod.backproject(cam, uv_cur, z_cur)
    xc_cand = torch.gather(xc_grp, 1, j[..., None].expand(B, N, 3))
    # Depth-adaptive inlier radius per correspondence.
    thr = torch.clamp_min(lc.se3_rel_threshold * z_cur, lc.se3_threshold)
    inl_gate = max(lc.se3_inliers,
                   int(round(lc.se3_inlier_frac * cfg.orb.n_features)))
    res = ransac_se3(xc_cand, xc_cur, ok, keys,
                     n_hypotheses=cfg.tracker.ransac_iters,
                     threshold=thr, min_inliers=inl_gate)
    # Refine the RANSAC SE3 at pixel accuracy and gate on the GN inliers.
    refined = optimize_pose(
        cfg, res.pose, xc_cand, uv_cur, z_cur, ok & (z_cur > 0), ok,
        map_state.kf_octave[cur], inliers0=res.inliers,
    )
    is_cand = (idx >= 0) & (idx < N)
    cand_inl = torch.sum(refined.inliers & ok & is_cand, dim=-1)
    enough_matches = torch.sum(ok & is_cand, dim=-1) >= lc.min_score_matches
    good = (
        res.ok
        & enough_matches
        & (refined.n_inliers >= inl_gate)       # pooled geometric evidence
        & (cand_inl * 2 >= inl_gate)            # direct-overlap requirement
    )
    idx_cand = torch.where(is_cand, idx, -1)
    return (good, refined.pose, refined.n_inliers, idx_cand,
            refined.inliers & ok & (idx_cand >= 0))


def verify_loop(cfg: SlamConfig, map_state, kf_cur, kf_cand, key):
    """One request of ``verify_loops_batch``: scalar slots, ``key`` a
    ``torch.Generator`` or Gumbel noise [H, N]."""
    if isinstance(key, torch.Tensor):
        key = key[None]
    out = verify_loops_batch(cfg, map_state, kf_cur.reshape(1),
                             kf_cand.reshape(1), key)
    return tuple(o[0] for o in out)
