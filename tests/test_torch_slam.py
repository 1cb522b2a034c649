"""The port's slice as a whole: ``run_sequence`` against the JAX engine on
the orbit of tests/test_slam_e2e.py, the host bookkeeping and wire helpers,
the entry points' device rule, state conversion and import hygiene.

Whole-slice tolerances: the same keyframe-event frames, every anchored
pose within 1 cm of JAX's, and ATE within 10% + 1 mm of JAX's (float32
solvers with another summation order drift apart slowly over a run)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_parity as tp
from boslam_tpu_torch import convert
from boslam_tpu_torch.geometry import align
from boslam_tpu_torch.io import synthetic
from boslam_tpu_torch.slam import (
    O_CULL0, O_LCAND, OUT_DIM, SlamSystem, depth_to_u16, depth_wire,
    run_sequence, to_gray_u8,
)

ROOT = Path(__file__).resolve().parents[1]
POSE_ATOL_M = 0.01
ATE_RTOL, ATE_ATOL_M = 0.10, 0.001


def _kf_frames(slam):
    return [i for i, m in enumerate(slam.metrics)
            if m.get("event") in ("init", "keyframe")]


def _ate(est, gt):
    rmse, _ = align.ate_rmse(torch.from_numpy(np.asarray(est[:, 4:], np.float32)),
                             torch.from_numpy(np.asarray(gt[:, 4:], np.float32)))
    return float(rmse)


@pytest.fixture(scope="module")
def runs():
    cfg_j, cfg_t = tp.configs(tp.E2E)
    traj = synthetic.orbit_trajectory(40, radius=0.5, yaw_amplitude=0.2)
    frames = synthetic.render_sequence(cfg_t.camera, traj)
    ref = tp.jax_engine(cfg_j, frames)
    got = run_sequence(cfg_t, frames, device="cpu")
    return traj, ref, got


def test_run_sequence_matches_jax_engine(runs):
    traj, ref, got = runs
    assert len(got.metrics) == 40
    assert _kf_frames(got) == _kf_frames(ref)
    assert not any(m["lost"] for m in got.metrics)
    assert [m["status"] for m in got.metrics] == [m["status"] for m in ref.metrics]
    _, est_ref = ref.trajectory()
    _, est = got.trajectory()
    assert est.shape == (40, 7) and np.all(np.isfinite(est))
    np.testing.assert_array_less(
        np.linalg.norm(est[:, 4:] - est_ref[:, 4:], axis=1), POSE_ATOL_M)
    ate_ref, ate = _ate(est_ref, traj.poses_twc), _ate(est, traj.poses_twc)
    assert abs(ate - ate_ref) <= ATE_RTOL * ate_ref + ATE_ATOL_M, (ate, ate_ref)
    assert got.n_keyframes == ref.n_keyframes


def test_host_bookkeeping_matches_jax_engine(runs):
    """The packed rows' host side: keyframe ids, BA edge counts, the frames'
    reference keyframes and the cull chain agree with the reference."""
    _, ref, got = runs
    for m_ref, m in zip(ref.metrics, got.metrics):
        for k in ("event", "kf_id", "ba_edges"):
            assert m.get(k) == m_ref.get(k), k
        if "ba_cost0" in m_ref:
            np.testing.assert_allclose([m["ba_cost0"], m["ba_cost1"]],
                                       [m_ref["ba_cost0"], m_ref["ba_cost1"]],
                                       rtol=0.05)
    assert [r[:2] for r in got.frame_refs] == [r[:2] for r in ref.frame_refs]
    assert set(got.cull_chain) == set(ref.cull_chain)


def test_anchor_trajectory_matches_jax():
    """Frames on live, culled-then-chained and unresolvable keyframes."""
    from boslam_tpu.utils.trajectory import anchor_trajectory as j_anchor
    from boslam_tpu_torch.utils.trajectory import anchor_trajectory

    rng = np.random.default_rng(3)

    def poses(n):
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return np.concatenate([q, rng.normal(size=(n, 3))], 1).astype(np.float32)

    kf_pose, raw = poses(4), poses(6)
    kf_valid = np.array([True, True, False, True])
    kf_seq = np.array([0, 1, 5, 3], np.int32)
    rels = poses(6)
    refs = [(0, 0), (1, 1), (2, 2), (3, 3), (2, 4), (3, 9)]
    frame_refs = [(s, q, rels[i]) for i, (s, q) in enumerate(refs)]
    # (2, 2) was culled into the live (1, 1); (2, 4) into (2, 2) and on to
    # (1, 1); (3, 9) names a slot since reused and keeps its raw pose.
    chain = {(2, 2): (1, 1, poses(1)[0]), (2, 4): (2, 2, poses(1)[0])}
    args = (raw, frame_refs, chain, kf_pose, kf_valid, kf_seq)
    np.testing.assert_allclose(anchor_trajectory(*args), np.asarray(j_anchor(*args)),
                               atol=1e-5)


def test_wire_helpers_match_jax():
    from boslam_tpu import slam as j_slam

    cfg_j, cfg_t = tp.configs(dict(tp.E2E, camera=dict(tp.CAM, depth_wire_stride=2)))
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    depth = rng.uniform(0.0, 4.0, (240, 320)).astype(np.float32)
    depth[rng.random((240, 320)) < 0.2] = 0.0
    np.testing.assert_array_equal(to_gray_u8(rgb), j_slam.to_gray_u8(rgb))
    np.testing.assert_array_equal(depth_to_u16(depth, 5000.0),
                                  j_slam.depth_to_u16(depth, 5000.0))
    np.testing.assert_array_equal(depth_wire(depth, cfg_t.camera),
                                  j_slam.depth_wire(depth, cfg_j.camera))
    assert j_slam.OUT_DIM == OUT_DIM and j_slam.O_CULL0 == O_CULL0
    assert j_slam.O_LCAND == O_LCAND


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    cfg = tp.configs(tp.SMALL)[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamSystem(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sequence(cfg, [])
    assert SlamSystem(cfg, device="cpu").device.type == "cpu"


def test_a_lost_frame_raises_until_relocalization_is_ported():
    cfg = tp.configs(tp.E2E)[1]
    _, frames = tp.orbit_frames(cfg.camera, 1)
    slam = SlamSystem(cfg, device="cpu")
    slam.track = slam.track._replace(status=torch.tensor(2, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="relocaliz"):
        slam.feed(*frames[0])


def _jax_state(kind):
    """A JAX state of each kind as numpy, descriptor words above 2**31."""
    rng = np.random.default_rng(5)
    words = lambda *shape: rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    if kind == "map":
        from boslam_tpu.mapping.map_state import empty_map

        d = tp.np_dict(empty_map(tp.configs(tp.SMALL)[0]))
        d["pt_desc"] = words(*d["pt_desc"].shape)
        return d
    if kind == "track":
        from boslam_tpu.tracking.tracker import init_track_state

        return tp.np_dict(init_track_state())
    n = 16
    return dict(
        uv=rng.normal(size=(n, 2)).astype(np.float32),
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        depth=rng.random(n).astype(np.float32), desc=words(n, 8),
        angle=rng.random(n).astype(np.float32),
        octave=rng.integers(0, 8, n).astype(np.int32),
        response=rng.random(n).astype(np.float32),
        valid=rng.random(n) < 0.5, has_depth=rng.random(n) < 0.5)


@pytest.mark.parametrize("kind", ["map", "track", "features"])
def test_convert_round_trips_uint32_bits(kind):
    to_port, to_np = {
        "map": (convert.map_state_from_numpy, convert.map_state_to_numpy),
        "track": (convert.track_state_from_numpy, convert.track_state_to_numpy),
        "features": (convert.frame_features_from_numpy,
                     convert.frame_features_to_numpy),
    }[kind]
    d = _jax_state(kind)
    state = to_port(d, "cpu")
    assert all(v.dtype != torch.uint32 for v in state)
    back = to_np(state)
    assert back.keys() == d.keys()
    for k, v in d.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError):
        to_port({k: v for k, v in d.items() if k != next(iter(d))}, "cpu")


def test_import_leaves_out_jax_and_the_jax_package():
    code = (
        "import pkgutil, sys, boslam_tpu_torch\n"
        "for m in pkgutil.walk_packages(boslam_tpu_torch.__path__, "
        "'boslam_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'boslam_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('boslam_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 25
