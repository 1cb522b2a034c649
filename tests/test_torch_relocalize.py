"""Relocalization parity of the port (``tracking/tracker.relocalize``)
against the JAX package: the whole-map path on a map of
``FUSED_MATCH_MIN_POINTS`` points (where the JAX package runs its Pallas
matcher, here in interpret mode, and the port its kernel's twin) and the
four-candidate BoW path with an alias keyframe.

The RANSAC noise is JAX's own: the Gumbel draws of the per-candidate keys
``jax.random.split(key, R)`` that ``relocalize`` hands its solver.

Tolerances: matches, ``good``, inlier counts and status exact; poses within
1e-4 (float32 solvers, another summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from boslam_tpu.features import extract_features
from boslam_tpu.geometry import se3 as j_se3
from boslam_tpu.loopclosure import empty_loop_state as j_empty_loop
from boslam_tpu.loopclosure import vocab as j_vocab
from boslam_tpu.mapping import empty_map as j_empty_map
from boslam_tpu.mapping import map_ops as j_map_ops
from boslam_tpu.tracking import init_track_state as j_init_track
from boslam_tpu.tracking import relocalize as j_relocalize
from boslam_tpu.tracking.tracker import FUSED_MATCH_MIN_POINTS as J_MIN_POINTS
from boslam_tpu_torch import convert
from boslam_tpu_torch.io import synthetic
from boslam_tpu_torch.loopclosure import empty_loop_state
from boslam_tpu_torch.tracking import tracker

POSE = 1e-4


def _noise(cfg, key):
    R, H, N = (cfg.tracker.reloc_candidates, cfg.tracker.ransac_iters,
               cfg.orb.n_features)
    return torch.from_numpy(np.stack(
        [np.array(jax.random.gumbel(k, (H, N))) for k in jax.random.split(key, R)]))


def _features(cfg_j, rgb, depth):
    from boslam_tpu.features.frontend import rgb_to_gray

    return extract_features(jnp.asarray(rgb_to_gray(rgb)), jnp.asarray(depth), cfg_j)


def _port(nt, fn):
    return tp.port_state(nt, fn)


def _lost_track():
    return j_init_track()._replace(status=jnp.asarray(2, jnp.int32))


def _compare(ref, got):
    t_ref, good_ref, n_ref = ref
    t, good, n = got
    assert bool(good) == bool(good_ref)
    assert int(n) == int(n_ref)
    for f in ("status", "last_kf", "frame_idx"):
        assert int(getattr(t, f)) == int(getattr(t_ref, f)), f
    np.testing.assert_allclose(t.pose_cw.numpy(), np.asarray(t_ref.pose_cw), atol=POSE)


@pytest.fixture(scope="module")
def big_map():
    """One keyframe at the origin in a map of FUSED_MATCH_MIN_POINTS points
    and the features of a frame from a nearby pose."""
    assert tracker.FUSED_MATCH_MIN_POINTS == J_MIN_POINTS
    d = dict(tp.E2E, map=dict(max_keyframes=16, max_points=J_MIN_POINTS))
    cfg_j, cfg_t = tp.configs(d)
    cam = cfg_t.camera
    rgb, depth = synthetic.render_frame(cam, np.array([1.0, 0, 0, 0, 0, 0, 0]))
    st = j_empty_map(cfg_j)
    n = cfg_j.orb.n_features
    st, _ = j_map_ops.insert_keyframe(
        cfg_j, st, _features(cfg_j, rgb, depth), j_se3.pose_identity(),
        jnp.full((n,), -1, jnp.int32), jnp.zeros((n,), bool), 0)
    pose = np.array([1.0, 0, 0, 0, 0.05, 0.0, 0.1])
    f1 = _features(cfg_j, *synthetic.render_frame(cam, pose))
    return cfg_j, cfg_t, st, f1, pose


def test_global_match_twin_matches_pallas_kernel(big_map):
    """The whole-map match of the global path: the port's B3 twin against
    the JAX package's Pallas kernel (interpret mode), exact."""
    from boslam_tpu.ops.hamming_pallas import fused_match_top2 as j_fused

    cfg_j, cfg_t, st, f1, _ = big_map
    P = cfg_j.map.max_points
    n = cfg_j.orb.n_features
    args_j = (f1.desc, f1.uv, jnp.full((n,), jnp.inf), f1.valid & f1.has_depth,
              st.pt_desc, jnp.zeros((P, 2)), st.pt_valid)
    ref = j_fused(*args_j, max_dist=cfg_j.matcher.hamming_low, ratio=0.85,
                  mutual=True, interpret=True)
    from boslam_tpu_torch.ops.hamming_cuda import fused_match_top2

    got = fused_match_top2(*(tp.t(np.asarray(a)) for a in args_j),
                           max_dist=cfg_t.matcher.hamming_low, ratio=0.85, mutual=True)
    assert int(np.sum(ref[1])) > 30
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    ok = np.asarray(ref[1])
    np.testing.assert_array_equal(got[2].numpy()[ok], np.asarray(ref[2])[ok])


def test_relocalize_global_path_large_map(big_map):
    cfg_j, cfg_t, st, f1, pose = big_map
    key = jax.random.key(0)
    ref = j_relocalize(cfg_j, st, j_empty_loop(cfg_j), _lost_track(), f1, key)
    sync = tracker.HostSync()
    got = tracker.relocalize(
        cfg_t, _port(st, convert.map_state_from_numpy), empty_loop_state(cfg_t, "cpu"),
        _port(_lost_track(), convert.track_state_from_numpy),
        _port(f1, convert.frame_features_from_numpy), _noise(cfg_t, key), sync)
    assert sync.count == 1  # the vocab_ready branch
    assert bool(ref[1])
    _compare(ref, got)
    est = np.asarray(j_se3.pose_inv(ref[0].pose_cw))
    np.testing.assert_allclose(est[4:], pose[4:], atol=0.02)


@pytest.fixture(scope="module")
def alias_scene():
    """The JAX engine over 30 orbit frames with a trained vocabulary, plus an
    alias keyframe (a 180-degree-turned view) whose BoW row is poisoned with
    the query's own vector, so it outscores every genuine candidate."""
    from boslam_tpu.slam import run_sequence

    cfg_j, cfg_t = tp.configs(dict(tp.E2E, loop=dict(vocab_train_kf=3)))
    traj = synthetic.orbit_trajectory(30, radius=0.5, yaw_amplitude=0.2)
    frames = synthetic.render_sequence(cfg_t.camera, traj)
    slam = run_sequence(cfg_j, frames)
    assert bool(slam.loop.vocab_ready)
    alias_twc = np.array([0.0, 0, 1.0, 0, 0.0, 0.0, 1.0])
    f_alias = _features(cfg_j, *synthetic.render_frame(cfg_t.camera, alias_twc))
    n = cfg_j.orb.n_features
    st, alias_slot = j_map_ops.insert_keyframe(
        cfg_j, slam.map, f_alias, j_se3.pose_inv(jnp.asarray(alias_twc, jnp.float32)),
        jnp.full((n,), -1, jnp.int32), jnp.zeros((n,), bool), 999)
    qi = 3
    f_q = _features(cfg_j, frames[qi][1], frames[qi][2])
    q_bow = j_vocab.bow_vector(cfg_j, slam.loop.vocab, f_q.desc, f_q.valid,
                               idf=slam.loop.idf)
    ls = slam.loop._replace(kf_bow=slam.loop.kf_bow.at[alias_slot].set(q_bow))
    return cfg_j, cfg_t, st, ls, f_q, traj.poses_twc[qi]


@pytest.mark.parametrize("candidates", [4, 1])
def test_bow_path_survives_alias(alias_scene, candidates):
    """Four candidates recover through candidate #2; one candidate is sunk
    by the alias, in both packages."""
    cfg_j, cfg_t, st, ls, f_q, pose = alias_scene
    cfg_j = cfg_j.replace(tracker=dataclasses.replace(
        cfg_j.tracker, reloc_candidates=candidates))
    cfg_t = cfg_t.replace(tracker=dataclasses.replace(
        cfg_t.tracker, reloc_candidates=candidates))
    key = jax.random.key(1)
    ref = j_relocalize(cfg_j, st, ls, _lost_track(), f_q, key)
    got = tracker.relocalize(
        cfg_t, _port(st, convert.map_state_from_numpy),
        _port(ls, convert.loop_state_from_numpy),
        _port(_lost_track(), convert.track_state_from_numpy),
        _port(f_q, convert.frame_features_from_numpy), _noise(cfg_t, key))
    assert bool(ref[1]) == (candidates > 1)
    _compare(ref, got)
    if candidates > 1:
        est = np.asarray(j_se3.pose_inv(ref[0].pose_cw))
        np.testing.assert_allclose(est[4:], pose[4:], atol=0.05)


def test_relocalize_draws_from_a_generator(big_map):
    """The engine's route: noise drawn from a torch.Generator."""
    cfg_j, cfg_t, st, f1, pose = big_map
    t, good, n_inl = tracker.relocalize(
        cfg_t, _port(st, convert.map_state_from_numpy), empty_loop_state(cfg_t, "cpu"),
        _port(_lost_track(), convert.track_state_from_numpy),
        _port(f1, convert.frame_features_from_numpy), torch.Generator().manual_seed(0))
    assert bool(good) and int(t.status) == tracker.ST_OK and int(n_inl) > 30
    from boslam_tpu_torch.geometry import se3

    np.testing.assert_allclose(se3.pose_inv(t.pose_cw)[4:].numpy(), pose[4:], atol=0.02)
