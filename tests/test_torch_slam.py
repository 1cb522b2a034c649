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


# Frame 10 loses tracking before a flush has trained the vocabulary, so
# frame 11 relocalizes against the whole map; frame 33 loses it again after
# the second flush trained it, and frame 34 relocalizes through the BoW
# candidates.
KIDNAP_BLANK = (10, 33)


@pytest.fixture(scope="module")
def kidnap():
    cfg_j, cfg_t = tp.configs(tp.E2E)
    traj = synthetic.orbit_trajectory(40, radius=0.5, yaw_amplitude=0.2)
    frames = tp.blank(synthetic.render_sequence(cfg_t.camera, traj), KIDNAP_BLANK)
    ready = []
    got = tp.port_engine(cfg_t, frames, ready)
    return traj, tp.jax_engine(cfg_j, frames), got, ready


def _reloc(slam):
    return [(i, m["reloc_ok"]) for i, m in enumerate(slam.metrics)
            if "reloc_ok" in m]


def test_kidnap_run_matches_jax_engine(kidnap):
    """Both relocalization paths: the same statuses, relocalization records
    and keyframe frames as the JAX engine; poses within 1 cm, ATE within
    10% + 1 mm."""
    traj, ref, got, ready = kidnap
    assert _reloc(ref) == [(11, True), (34, True)]
    assert _reloc(got) == _reloc(ref)
    assert [ready[i] for i, _ in _reloc(got)] == [False, True]  # global, BoW
    assert [m["status"] for m in got.metrics] == [m["status"] for m in ref.metrics]
    assert [m.get("event") for m in got.metrics] == [m.get("event") for m in ref.metrics]
    assert _kf_frames(got) == _kf_frames(ref)
    _, est_ref = ref.trajectory()
    _, est = got.trajectory()
    np.testing.assert_array_less(
        np.linalg.norm(est[:, 4:] - est_ref[:, 4:], axis=1), POSE_ATOL_M)
    ate_ref, ate = _ate(est_ref, traj.poses_twc), _ate(est, traj.poses_twc)
    assert abs(ate - ate_ref) <= ATE_RTOL * ate_ref + ATE_ATOL_M, (ate, ate_ref)


def test_loop_fields_match_jax_engine(runs):
    """The packed rows' loop fields (candidate and BoW score per keyframe)
    and the loop state they come from: vocabulary, BoW rows, streaks."""
    _, ref, got = runs
    assert [m.get("loop_candidate") for m in got.metrics] == \
        [m.get("loop_candidate") for m in ref.metrics]
    for m_ref, m in zip(ref.metrics, got.metrics):
        if "loop_score" in m_ref:
            assert m["loop_score"] == pytest.approx(m_ref["loop_score"], abs=1e-4)
    assert bool(got.loop.vocab_ready) and bool(ref.loop.vocab_ready)
    want = tp.np_dict(ref.loop)
    have = convert.loop_state_to_numpy(got.loop)
    for k in ("vocab", "streak_kf", "streak_len"):
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    np.testing.assert_allclose(have["kf_bow"], want["kf_bow"], atol=1e-5)


CLOSURE = dict(tp.E2E, loop=dict(min_gap_kf=8, consistency=2,
                                 min_score_matches=25),
               tracker=dict(kf_min_interval=2, kf_tracked_ratio=0.75))


@pytest.fixture(scope="module")
def closure():
    """The JAX engine on the closed orbit of tests/test_slam_e2e.py's loop
    test: its state when it dispatched the verification that closed a loop,
    and its map and tracker right after the closure."""
    from boslam_tpu.slam import SlamSystem as JaxSlam

    cfg_j, cfg_t = tp.configs(CLOSURE)
    traj = synthetic.orbit_trajectory(80, radius=1.2, yaw_amplitude=0.5, loop=True)
    frames = synthetic.render_sequence(cfg_t.camera, traj)
    snaps, closed = [], []

    class Capture(JaxSlam):
        def _dispatch_verify(self, loop_requests):
            if loop_requests:
                snaps.append(dict(
                    map=tp.np_dict(self.map), loop=tp.np_dict(self.loop),
                    track=tp.np_dict(self.track), key=self.key,
                    seq_host=dict(self._kf_seq_host), loops=self.n_loops_closed,
                    reqs=[(k, c) for k, c, _ in loop_requests]))
            super()._dispatch_verify(loop_requests)

        def _close_loop(self, kf_id, cand, *args, **kw):
            super()._close_loop(kf_id, cand, *args, **kw)
            closed.append(dict(snap=snaps[-1], pair=(kf_id, cand),
                               map=tp.np_dict(self.map),
                               track=tp.np_dict(self.track)))

    slam = Capture(cfg_j)
    for f in frames:
        slam.feed(*f)
    slam.trajectory()
    assert closed, "the JAX engine closed no loop"
    return cfg_t, closed[0]


def _replay_closure(cfg_t, snap):
    """A port engine holding the JAX state ``snap`` captured at dispatch,
    run through ``_dispatch_verify`` -> ``_resolve_pending_verify`` with
    JAX's RANSAC noise.  Returns (engine, the requests' records)."""
    import jax

    slam = SlamSystem(cfg_t, device="cpu")
    slam.map = convert.map_state_from_numpy(snap["map"], "cpu")
    slam.loop = convert.loop_state_from_numpy(snap["loop"], "cpu")
    slam.track = convert.track_state_from_numpy(snap["track"], "cpu")
    slam._kf_seq_host = dict(snap["seq_host"])
    slam.n_loops_closed = snap["loops"]
    # The noise the JAX dispatch drew: its key split once, then per request.
    keys = jax.random.split(jax.random.split(snap["key"])[1], slam.MAX_VERIFY)
    shape = (cfg_t.tracker.ransac_iters, cfg_t.orb.n_features)
    slam.generator = torch.from_numpy(
        np.stack([np.array(jax.random.gumbel(k, shape)) for k in keys]))
    recs = [{} for _ in snap["reqs"]]
    slam.metrics = [recs[-1]]
    slam._dispatch_verify([(k, c_, r) for (k, c_), r in zip(snap["reqs"], recs)])
    slam._resolve_pending_verify()
    return slam, recs


def test_host_loop_closure_matches_jax_engine(closure):
    """A JAX state with consistent candidates pending, carried into the
    port: ``_dispatch_verify`` -> ``_resolve_pending_verify`` ->
    ``_close_loop`` closes the same loop with JAX's RANSAC noise, and the
    corrected map and tracker agree."""
    cfg_t, c = closure
    snap = c["snap"]
    slam, recs = _replay_closure(cfg_t, snap)
    assert slam.n_loops_closed == snap["loops"] + 1 and slam.n_global_ba == 0
    closed = [pair for pair, r in zip(snap["reqs"], recs) if r.get("event") == "loop_closed"]
    assert closed == [c["pair"]]
    got_map = convert.map_state_to_numpy(slam.map)
    for k in ("kf_obs_pt", "pt_valid", "covis", "loop_edges", "n_loop_edges"):
        np.testing.assert_array_equal(got_map[k], c["map"][k], err_msg=k)
    for k in ("kf_pose", "pt_xyz", "loop_rel"):
        np.testing.assert_allclose(got_map[k], c["map"][k], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(slam.track.pose_cw.numpy(), c["track"]["pose_cw"], atol=1e-4)


# run_global_ba against the JAX engine: the record's edge count exactly,
# cost0 to rtol 1e-5 and cost1 to rtol 1e-3, poses and points within 1e-4.
GBA_COST0_RTOL, GBA_COST1_RTOL, GBA_ATOL = 1e-5, 1e-3, 1e-4


def _port_engine_from(cfg_t, ref):
    """A port engine on the CPU holding ``ref``'s map, tracker and metric
    records (copies, so that ``ref`` is left as it was)."""
    slam = SlamSystem(cfg_t, device="cpu")
    slam.map = convert.map_state_from_numpy(tp.np_dict(ref.map), "cpu")
    slam.track = convert.track_state_from_numpy(tp.np_dict(ref.track), "cpu")
    slam.metrics = [dict(m) for m in ref.metrics]
    return slam


def _assert_gba_record(have, want, cost0_rtol=GBA_COST0_RTOL,
                       cost1_rtol=GBA_COST1_RTOL):
    assert set(have) == set(want) == {"gba_cost0", "gba_cost1", "gba_edges",
                                      "gba_distributed"}
    assert have["gba_edges"] == want["gba_edges"] > 0
    assert have["gba_distributed"] is want["gba_distributed"] is False
    assert have["gba_cost0"] == pytest.approx(want["gba_cost0"], rel=cost0_rtol)
    assert have["gba_cost1"] == pytest.approx(want["gba_cost1"], rel=cost1_rtol)
    assert have["gba_cost1"] <= have["gba_cost0"]


def test_run_global_ba_matches_jax_engine(runs):
    """``run_global_ba`` on the JAX engine's map and tracker after the
    40-frame orbit, in both engines: the same record, keyframe poses,
    points and re-attached tracked pose (velocity reset)."""
    import copy

    _, ref, _ = runs
    jax_slam = copy.copy(ref)
    jax_slam.metrics = [dict(m) for m in ref.metrics]
    slam = _port_engine_from(tp.configs(tp.E2E)[1], ref)
    syncs = slam.sync.count
    want = jax_slam.run_global_ba()
    have = slam.run_global_ba()
    _assert_gba_record(have, want)
    assert slam.metrics[-1] == {**ref.metrics[-1], **have}
    assert "gba_cost0" not in ref.metrics[-1] and ref.n_global_ba == 0
    assert slam.n_global_ba == 1 and slam.sync.count > syncs
    for k in ("kf_pose", "pt_xyz"):
        np.testing.assert_allclose(getattr(slam.map, k).numpy(),
                                   np.asarray(getattr(jax_slam.map, k)),
                                   atol=GBA_ATOL, err_msg=k)
    np.testing.assert_allclose(slam.track.pose_cw.numpy(),
                               np.asarray(jax_slam.track.pose_cw), atol=GBA_ATOL)
    np.testing.assert_array_equal(slam.track.velocity.numpy(),
                                  [1, 0, 0, 0, 0, 0, 0])


def test_loop_closure_runs_global_ba_when_asked(closure):
    """With ``loop.run_global_ba`` set, ``_close_loop`` runs global BA once
    after the correction: ``n_global_ba`` counts it, the last metric record
    gets its ``gba_*`` keys, and the map is the JAX global BA of JAX's
    corrected map (cost0 to rtol 1e-4, as the two corrected maps differ by
    up to 1e-4; cost1 to rtol 1e-3; poses and points within 1e-4)."""
    import dataclasses

    import jax.numpy as jnp

    from boslam_tpu.mapping.map_state import MapState as JaxMapState
    from boslam_tpu.solvers.global_ba import global_bundle_adjustment

    cfg_j, cfg_t = tp.configs(CLOSURE)
    cfg_t = cfg_t.replace(loop=dataclasses.replace(cfg_t.loop,
                                                   run_global_ba=True))
    _, c = closure
    slam, recs = _replay_closure(cfg_t, c["snap"])
    assert slam.n_loops_closed == c["snap"]["loops"] + 1
    assert slam.n_global_ba == 1
    have = {k: v for k, v in slam.metrics[-1].items() if k.startswith("gba_")}
    st = convert.map_state_from_numpy(c["map"], "cpu")
    jax_map = JaxMapState(**{k: jnp.asarray(v) for k, v in c["map"].items()})
    want_map, stats = global_bundle_adjustment(
        cfg_j, jax_map, lm_iters=cfg_j.loop.global_ba_iters,
        cg_iters=cfg_j.loop.global_ba_cg_iters)
    want = {"gba_cost0": float(stats.cost0), "gba_cost1": float(stats.cost1),
            "gba_edges": int(stats.n_edges), "gba_distributed": False}
    _assert_gba_record(have, want, cost0_rtol=1e-4)
    for k in ("kf_pose", "pt_xyz"):
        np.testing.assert_allclose(getattr(slam.map, k).numpy(),
                                   np.asarray(getattr(want_map, k)),
                                   atol=1e-4, err_msg=k)
    assert not torch.equal(slam.map.kf_pose, st.kf_pose)


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
