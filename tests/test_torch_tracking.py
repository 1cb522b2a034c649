"""Tracking parity of the port: optimize_pose and track_frame on a JAX map
carried over by ``convert``.  Poses within atol 1e-4 (float32 GN with
another summation order), inlier masks, match ids and decisions exact."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import _torch_parity as tp
from boslam_tpu.matching.projection import search_by_projection as j_search
from boslam_tpu.solvers.pose_opt import optimize_pose as j_optimize_pose
from boslam_tpu.tracking.tracker import _local_point_mask as j_local_mask
from boslam_tpu.tracking.tracker import track_frame as j_track_frame
from boslam_tpu_torch import convert
from boslam_tpu_torch.solvers.pose_opt import optimize_pose
from boslam_tpu_torch.tracking.tracker import HostSync, _local_point_mask, track_frame

POSE_ATOL = 1e-4


@pytest.fixture(scope="module")
def scene():
    cfg_j, cfg_t, slam, feats_j = tp.scenario(tp.SMALL, 6)
    ms_t = tp.port_state(slam.map, convert.map_state_from_numpy)
    tr_t = tp.port_state(slam.track, convert.track_state_from_numpy)
    f_t = tp.port_state(feats_j, convert.frame_features_from_numpy)
    return cfg_j, cfg_t, slam, feats_j, ms_t, tr_t, f_t


def test_local_point_mask_matches_jax(scene):
    _, _, slam, _, ms_t, tr_t, _ = scene
    np.testing.assert_array_equal(
        _local_point_mask(ms_t, tr_t.last_kf).numpy(),
        np.asarray(j_local_mask(slam.map, slam.track.last_kf)))


def test_optimize_pose_matches_jax(scene):
    cfg_j, cfg_t, slam, feats_j, ms_t, _, f_t = scene
    from boslam_tpu.geometry import se3 as j_se3

    ms = slam.map
    # The motion-model prediction and the gated search of tracking pass 1.
    pose0 = j_se3.pose_compose(slam.track.velocity, slam.track.pose_cw)
    idx, ok, _, _ = j_search(cfg_j, feats_j, pose0, ms.pt_xyz, ms.pt_desc,
                             ms.pt_valid, radius=15.0, max_dist=50, ratio=0.9,
                             pt_angle=ms.pt_angle, pt_dir_sum=ms.pt_dir_sum,
                             pt_dmin=ms.pt_dmin, pt_dmax=ms.pt_dmax)
    pts = np.array(ms.pt_xyz)[np.clip(np.asarray(idx), 0, None)]
    has_d = np.asarray(feats_j.has_depth) & np.asarray(ok)
    ref = j_optimize_pose(cfg_j, pose0, jnp.asarray(pts), feats_j.uv, feats_j.depth,
                          jnp.asarray(has_d), ok, feats_j.octave)
    got = optimize_pose(cfg_t, tp.t(pose0), torch.from_numpy(pts), f_t.uv, f_t.depth,
                        torch.from_numpy(has_d), tp.t(ok), f_t.octave)
    assert int(ref.n_inliers) > 20
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=POSE_ATOL)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers)
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-4)


def _compare_track(cfg_j, cfg_t, slam, feats_j, ms_t, tr_t, f_t):
    ref_tr, ref_out = j_track_frame(cfg_j, slam.map, slam.track, feats_j)
    sync = HostSync()
    got_tr, got_out = track_frame(cfg_t, ms_t, tr_t, f_t, sync)
    assert sync.count == 1  # the wide-pass branch
    for k in ("pose_cw", "velocity"):
        np.testing.assert_allclose(getattr(got_tr, k).numpy(),
                                   np.asarray(getattr(ref_tr, k)), atol=POSE_ATOL,
                                   err_msg=k)
    for k in ("status", "n_since_kf", "last_kf", "frame_idx"):
        assert int(getattr(got_tr, k)) == int(getattr(ref_tr, k)), k
    for k in ("match_pt", "match_ok", "visible", "n_inliers", "n_visible",
              "n_matches", "need_kf", "lost"):
        np.testing.assert_array_equal(getattr(got_out, k).numpy(),
                                      np.asarray(getattr(ref_out, k)), err_msg=k)
    np.testing.assert_allclose(got_out.scalars.numpy(), np.asarray(ref_out.scalars))
    return ref_out


def test_track_frame_matches_jax(scene):
    out = _compare_track(*scene)
    assert not bool(out.lost) and int(out.n_inliers) > 40


def test_track_frame_wide_pass_and_lost_match_jax(scene):
    """min_inliers above the match count: the wide fallback pass runs and
    the frame ends lost (pose held, velocity reset) on both sides."""
    import dataclasses

    cfg_j, cfg_t, slam, feats_j, ms_t, tr_t, f_t = scene
    cfg_j = cfg_j.replace(tracker=dataclasses.replace(cfg_j.tracker, min_inliers=400))
    cfg_t = cfg_t.replace(tracker=dataclasses.replace(cfg_t.tracker, min_inliers=400))
    out = _compare_track(cfg_j, cfg_t, slam, feats_j, ms_t, tr_t, f_t)
    assert bool(out.lost)
