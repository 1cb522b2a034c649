"""The frozen copies and the plain references against the program they
were taken from, on the CPU at small sizes.  Only these tests import the
port beside the reference."""

import numpy as np
import pytest
import torch

import core
import problem
import render
from reference import ba as ref_ba
from reference.frontend import Frontend
from reference.geometry import ate_rmse, exp, pose_compose, quat_to_mat


def _frame(config, traffic, i):
    slam_cfg = core.load_json("configs", config)["slam"]
    tr = core.load_json("traffic", traffic)
    traj = render.trajectory(tr["path"])
    traj = render.Trajectory(traj.poses_twc[i:i + 1], traj.timestamps[i:i + 1])
    frame = render.render_wire(render.Camera.from_config(slam_cfg), traj,
                               depth_noise=tr["depth_noise"],
                               room_scale=tr["room_scale"],
                               generator=torch.Generator().manual_seed(9),
                               device="cpu")[0]
    return slam_cfg, frame


@pytest.mark.parametrize("config,traffic,i", [
    ("tum_vga512", "hall_replay_chunk1", 40),
    ("icl_survey1024", "survey_replay_chunk1", 120),
])
def test_frozen_frontend_is_the_programs(config, traffic, i):
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.features.frontend import extract_features

    slam_cfg, (_, gray, d16) = _frame(config, traffic, i)
    ref = Frontend(slam_cfg, "cpu")(torch.from_numpy(gray),
                                    torch.from_numpy(d16.astype(np.int32)))
    cfg = SlamConfig.from_dict(slam_cfg)
    got = extract_features(torch.from_numpy(gray).float(),
                           torch.from_numpy(d16.astype(np.int32)).float()
                           * (1.0 / cfg.camera.depth_factor), cfg)
    for key in ("uv", "depth", "desc", "angle", "octave", "valid"):
        assert torch.equal(getattr(ref, key), getattr(got, key)), key
    assert int(ref.valid.sum()) == slam_cfg["orb"]["n_features"]


def test_geometry_matches_the_programs():
    from boslam_tpu_torch.geometry import se3

    xi = torch.tensor([[0.1, -0.2, 0.3, 0.5, -1.0, 2.0],
                       [1e-8, 0.0, 0.0, 0.1, 0.2, 0.3]], dtype=torch.float64)
    p = exp(xi)
    torch.testing.assert_close(p.float(), se3.exp(xi.float()), rtol=0, atol=2e-6)
    torch.testing.assert_close(pose_compose(p, p.flip(0)).float(),
                               se3.pose_compose(p.float(), p.flip(0).float()),
                               rtol=0, atol=2e-6)
    torch.testing.assert_close(quat_to_mat(p[:, :4]).float(),
                               se3.quat_to_mat(p[:, :4].float()), rtol=0,
                               atol=1e-6)


def test_ate_removes_a_rigid_motion():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(50, 3))
    R = quat_to_mat(exp(torch.tensor([0.3, -0.2, 0.1, 0, 0, 0],
                                     dtype=torch.float64))[:4]).numpy()
    est = gt @ R.T + [1.0, -2.0, 0.5]
    assert ate_rmse(est, gt)[0] < 1e-12
    step = np.where(np.arange(50)[:, None] < 25, 0.1, -0.1) * [1.0, 0, 0]
    assert 0.09 < ate_rmse(est + step @ R.T, gt)[0] <= 0.1 + 1e-12


def _problem(seed):
    slam_cfg = core.load_json("configs", "icl_survey1024")["slam"]
    tr = core.load_json("traffic", "gba_synthetic_50k")
    return slam_cfg, problem.make(dict(tr, **tr["rehearsal"]), slam_cfg, seed)


def test_problem_structure_is_fixed_and_noise_follows_the_seed():
    _, a = _problem(1)
    _, b = _problem(2**31 + 3)
    assert np.array_equal(a["kf_obs"], b["kf_obs"])
    assert np.array_equal(a["pt_valid"], b["pt_valid"])
    assert not np.array_equal(a["kf_uv"], b["kf_uv"])
    assert not np.array_equal(a["kf_pose"], b["kf_pose"])
    assert np.array_equal(_problem(1)[1]["kf_uv"], a["kf_uv"])


def test_reference_objective_and_solve_match_the_programs():
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.solvers import ba_core
    from boslam_tpu_torch.solvers.global_ba import (
        build_global_edges, global_bundle_adjustment,
    )

    import gba

    slam_cfg, raw = _problem(5)
    cfg = SlamConfig.from_dict(slam_cfg)
    state = gba._program_map(cfg, raw, torch.device("cpu"))
    prog_cost = float(ba_core.robust_cost(
        cfg, state.kf_pose, state.pt_xyz, build_global_edges(cfg, state),
        cfg.local_ba.huber_delta))
    cam = ref_ba.camera(slam_cfg)
    e = ref_ba.edges_from_map(raw, 1.2, torch.float64, "cpu")
    poses = torch.from_numpy(raw["kf_pose"]).double()
    pts = torch.from_numpy(raw["pt_xyz"]).double()
    assert float(ref_ba.cost(cam, poses, pts, e)) == pytest.approx(prog_cost,
                                                                   rel=1e-5)
    out, stats = global_bundle_adjustment(cfg, state, lm_iters=6, cg_iters=40)
    opt = torch.from_numpy(raw["kf_valid"]).clone()
    opt[0] = False
    _, _, c0, c1 = ref_ba.levenberg_marquardt(cam, poses, pts, e, opt, 6)
    assert float(c0) == pytest.approx(float(stats.cost0), rel=1e-5)
    assert float(c1) < 0.05 * float(c0)
    assert float(c1) == pytest.approx(float(stats.cost1), rel=1e-2)


@pytest.mark.parametrize("center", [3, 9])
def test_reference_local_ba_is_the_programs(center):
    """On a map whose window is cut small (4 moving, 3 fixed keyframes, 200
    points, so that the selection and the cut both bite), the reference
    works out the program's window and follows its solve."""
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.mapping.map_state import recompute_covis
    from boslam_tpu_torch.solvers.local_ba import local_bundle_adjustment

    import frames
    import gba

    slam_cfg = core.load_json("configs", "icl_survey1024")["slam"]
    tr = core.load_json("traffic", "gba_synthetic_50k")
    raw = problem.make(dict(tr, n_kf=16, n_pts=900, obs_per_kf=128),
                       slam_cfg, 7)
    slam_cfg = dict(slam_cfg, local_ba=dict(
        slam_cfg["local_ba"], n_opt_kf=4, n_fixed_kf=3, max_local_points=200))
    cfg = SlamConfig.from_dict(slam_cfg)
    state = recompute_covis(gba._program_map(cfg, raw, torch.device("cpu")))
    c = torch.tensor(center, dtype=torch.int32)
    out, stats = local_bundle_adjustment(cfg, state, c)
    arrays = {name: getattr(state, k) for k, name in frames.LBA_INPUTS.items()}
    gaps = frames.local_ba_gaps((arrays, c, out.kf_pose, out.pt_xyz, stats),
                                slam_cfg, torch.device("cpu"))
    assert max(gaps.values()) < 1e-5, gaps
    cams, moves, pts, e = ref_ba.local_window(
        {k: v.numpy() for k, v in arrays.items()}, center, slam_cfg["local_ba"],
        1.2, torch.float64, "cpu")
    assert int(stats.n_edges) == e.cam.shape[0]
    moved = torch.nonzero((out.kf_pose != state.kf_pose).any(1))[:, 0]
    assert sorted(moved.tolist()) == sorted(cams[moves.numpy()].tolist())
    assert len(cams) == 7 and len(pts) == 200
    moved_pts = torch.nonzero((out.pt_xyz != state.pt_xyz).any(1))[:, 0]
    assert set(moved_pts.tolist()) <= set(pts.tolist())
