"""The port's bench (``boslam_tpu_torch.bench``) against the JAX package's
``bench.py`` on the CPU, the same inputs through both:

* ``Budget``: the same calls give the same skipped phases and phase keys;
* ``RenderFeed``: the main and a queued sequence bit-equal;
* the tracking phase on a small clover at tum_mini's 160x120 camera:
  keyframes, lost frames and loops equal to ``bench._run_engine``'s, the ATE
  within 1.25 x the reference's + 5 mm, loops on and off; the batch pass's
  poses within 1e-6 m of the stream pass's;
* the global-BA phase on a 16-keyframe, 2000-point synthetic problem:
  edges and landmarks exact, the cost reduction within 1 %.
"""

import sys
import time

import numpy as np
import pytest

import _torch_parity as tp

sys.path.insert(0, str(tp.ROOT))

import bench as jbench  # noqa: E402
from boslam_tpu_torch import bench  # noqa: E402
from boslam_tpu_torch.io import synthetic  # noqa: E402

ATE_FACTOR, ATE_SLACK_M = 1.25, 0.005
POSE_ATOL_M = 1e-6

# A small clover at tum_mini's camera with the bench's tracking policy.
CLOVER_CFG = {
    "camera": dict(tp.TUM_MINI_CAM, depth_wire_stride=2),
    "orb": dict(n_features=256, n_levels=4),
    "map": dict(max_keyframes=32, max_points=4096),
    "loop": dict(min_gap_kf=6, consistency=2),
    "tracker": dict(kf_min_interval=2, kf_tracked_ratio=0.8),
}


def test_budget_matches_jax():
    budgets = [jbench.Budget(0.2), bench.Budget(0.2)]
    for name, est in (("cheap", 0.0), ("expensive", 10.0)):
        assert len({b.allow(name, est) for b in budgets}) == 1
    for b in budgets:
        with b.timed("run"):
            time.sleep(0.01)
    time.sleep(0.25)
    assert len({b.allow("late", 0.01) for b in budgets}) == 1
    assert budgets[0].skipped == budgets[1].skipped == ["expensive", "late"]
    assert budgets[0].phase_times.keys() == budgets[1].phase_times.keys()
    assert all(b.remaining() < 0 for b in budgets)


def test_render_feed_matches_jax():
    cfg_j, cfg_t = tp.configs({"camera": dict(width=64, height=48, fx=32.0,
                                              fy=32.0, cx=32.0, cy=24.0,
                                              depth_wire_stride=2)})
    traj = synthetic.orbit_trajectory(6, radius=0.3)
    kw = dict(depth_noise=0.01, seed=0, room_scale=1.0)
    ref = jbench.RenderFeed(cfg_j, traj, **kw)
    ref.queue("alt", cfg_j, traj, depth_noise=0.02, seed=1, room_scale=1.0)
    rf = bench.RenderFeed(cfg_t, traj, **kw)
    try:
        rf.queue("alt", cfg_t, traj, depth_noise=0.02, seed=1, room_scale=1.0)
        ts, gray, d16 = rf.get(2)
        assert gray.dtype == np.uint8 and gray.shape == (48, 64)
        assert d16.dtype == np.uint16 and d16.shape == cfg_t.camera.depth_wire_shape
        pairs = [(rf.wait_main(), ref.wait_main()),
                 (rf.wait_extra("alt", 120.0), ref.wait_extra("alt", 120.0))]
        assert rf.wait_extra("nope", 0.1) is None
    finally:
        rf.close()
    for got, want in pairs:
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g[0] == w[0]
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_array_equal(g[2], w[2])
    assert not np.array_equal(pairs[1][0][0][2], pairs[0][0][0][2])


@pytest.fixture(scope="module")
def clover():
    cfg_j, cfg_t = tp.configs(CLOVER_CFG)
    traj = synthetic.clover_trajectory(30, n_petals=3, radius=0.4,
                                       yaw_amplitude=0.2)
    frames = bench._render_wire(cfg_t, traj, 0.01, 3, 1.0)
    return cfg_j, cfg_t, traj, frames


def _bound(ref_ate):
    return ATE_FACTOR * ref_ate + ATE_SLACK_M


def test_tracking_phase_matches_jax(clover):
    cfg_j, cfg_t, traj, frames = clover
    extras, engines = bench.bench_tracking(
        cfg_t, frames, traj, budget=bench.Budget(900.0), device="cpu",
        n_passes=1, n_batch_passes=1)
    ref = jbench._run_engine(cfg_j, frames)
    ref_ate = jbench._ate(ref, traj)
    assert extras["keyframes"] == ref.n_keyframes
    assert extras["lost_frames"] == sum(1 for m in ref.metrics if m.get("lost"))
    assert extras["loops_closed"] == ref.n_loops_closed
    assert extras["ate_rmse_m"] <= _bound(ref_ate), (extras["ate_rmse_m"], ref_ate)
    assert len(extras["fps_runs"]) == len(extras["fps_batch_runs"]) == 1
    assert not any(k.endswith("_launches_per_frame") for k in extras)
    _, est_s = engines["stream"].trajectory()
    _, est_b = engines["batch"].trajectory()
    assert np.abs(est_s[:, 4:] - est_b[:, 4:]).max() <= POSE_ATOL_M

    off = bench.bench_error_budget_cheap(cfg_t, frames, traj, device="cpu")
    ref_off = jbench._ate(jbench._run_engine(cfg_j, frames, loop_off=True), traj)
    assert off.keys() == {"ate_loop_off_m"}
    assert off["ate_loop_off_m"] <= _bound(ref_off), (off, ref_off)


def test_global_ba_phase_matches_jax():
    from boslam_tpu.io.synthetic import synthetic_ba_problem
    from boslam_tpu.solvers.global_ba import global_bundle_adjustment

    n_kf, n_pts, obs = 16, 2000, 512
    got = bench.bench_global_ba(n_pts, n_kf=n_kf, obs_per_kf=obs, device="cpu")
    cfg_j, _ = tp.configs(dict(map=dict(max_keyframes=n_kf, max_points=65536),
                               orb=dict(n_features=512)))
    st, _, _ = synthetic_ba_problem(cfg_j, np.random.default_rng(0), n_kf=n_kf,
                                    n_pts=n_pts, obs_per_kf=obs)
    _, stats = global_bundle_adjustment(cfg_j, st, lm_iters=6, cg_iters=40)
    assert got["ba_edges"] == int(stats.n_edges)
    assert got["ba_landmarks"] == int(np.sum(np.asarray(st.pt_valid)))
    want = float(stats.cost0) / float(stats.cost1)
    assert abs(got["ba_cost_reduction"] - want) <= 0.01 * want
    assert got["ba_iters_per_sec"] > 0
