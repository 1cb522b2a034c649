"""The port's parallel layer (``boslam_tpu_torch.parallel``) against the
JAX package's (``boslam_tpu.parallel``), one test per test of
tests/test_parallel.py and named after it.

The sharded solvers run in real processes: ranks of a gloo process group
on the CPU (tests/_torch_dist_worker.py, rendezvous through a file under
the test's tmp_path), the JAX side on its 8-device CPU mesh in this
process.  Tolerances are those of tests/test_parallel.py, but for the
batched engine's poses: the port's single engine differs from JAX's single
engine by up to 1.4 mm on these 160x120 orbits (tracking frames whose
inlier sets part by one keypoint, ROADMAP C1), so the batched engine is held
against JAX's batched run at the whole-engine tolerance of
tests/test_torch_slam.py (1 cm, the same keyframe frames and count, map
points within 2%) and bit for bit against the port's single engine.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_parity as tp

WORKER = tp.ROOT / "tests" / "_torch_dist_worker.py"
POSE_ATOL_M = 0.01  # the whole-engine tolerance of tests/test_torch_slam.py

# tests/test_parallel.py's data-parallel configuration.
DP = {"camera": dict(width=160, height=120, fx=70.0, fy=70.0, cx=80.0,
                     cy=60.0),
      "orb": dict(n_features=128, n_levels=3)}


def _run_ranks(mode: str, world: int, tmp_path, inputs: dict):
    """MODE on ``world`` gloo ranks (one subprocess each); returns each
    rank's saved results."""
    src = tmp_path / f"{mode}_in.npz"
    np.savez(src, **inputs)
    rdzv = tmp_path / f"{mode}_rdzv"
    env = dict(os.environ, PYTHONPATH=str(tp.ROOT))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(r), str(world), str(rdzv),
         str(src), str(tmp_path / f"{mode}_out{r}.npz")],
        cwd=tp.ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    return [dict(np.load(tmp_path / f"{mode}_out{r}.npz"))
            for r in range(world)]


# --------------------------------------------------------------------------
def test_mesh_axes():
    from boslam_tpu_torch.parallel import make_mesh

    mesh = make_mesh(8, seq=2)
    assert mesh.shape["seq"] == 2 and mesh.shape["pt"] == 4
    assert mesh.ranks.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert make_mesh().shape == {"seq": 1, "pt": 1}
    assert make_mesh().group("pt") is None
    with pytest.raises(ValueError):
        make_mesh(6, seq=4)


def _ba_problem(noise_pose, noise_pt):
    """tests/test_parallel.py's local-BA problem (tests/test_local_ba.py's
    four cameras and 50 points) with its perturbation, from a seeded rng:
    (BA_CFG, gt_pts, edges, n_pts, poses0, pts0)."""
    from boslam_tpu.geometry import se3
    from tests.test_local_ba import CFG as BA_CFG, make_ba_problem

    rng = np.random.default_rng(0)
    gt_poses, gt_pts, edges, n_pts = make_ba_problem(rng)
    L = BA_CFG.local_ba.max_local_points
    poses0 = se3.retract(gt_poses, jnp.asarray(np.concatenate(
        [rng.normal(size=(2, 6)) * noise_pose, np.zeros((2, 6))])))
    pts0 = gt_pts + jnp.asarray(np.concatenate(
        [rng.normal(size=(n_pts, 3)) * noise_pt, np.zeros((L - n_pts, 3))]))
    return BA_CFG, gt_pts, edges, n_pts, poses0, pts0


def _ba_inputs(cfg_j, edges, poses0, pts0, n_iters):
    return dict(
        cfg=json.dumps({k: dataclasses.asdict(getattr(cfg_j, k))
                        for k in ("camera", "orb", "local_ba")}),
        poses0=np.asarray(poses0), pts0=np.asarray(pts0, np.float32),
        opt=np.array([True, True]), n_iters=n_iters,
        **{f: np.asarray(v) for f, v in edges._asdict().items()})


def test_sharded_ba_matches_single_device():
    """One shard in one process, against the JAX solver on its one-device
    mesh: every pose, point and cost within 1e-5."""
    from boslam_tpu.parallel import make_mesh as j_mesh
    from boslam_tpu.parallel.sharded_ba import (
        make_sharded_ba as j_make, shard_edges_by_point as j_shard,
        stripe_points as j_stripe,
    )
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.parallel import make_mesh
    from boslam_tpu_torch.parallel.sharded_ba import (
        make_sharded_ba, shard_edges_by_point, stripe_points,
    )
    from boslam_tpu_torch.solvers.ba_core import BaEdges

    cfg_j, _, edges, _, poses0, pts0 = _ba_problem(0.03, 0.05)
    L = cfg_j.local_ba.max_local_points
    e1, _ = j_shard(edges, L, 1)
    p1, _ = j_stripe(pts0, 1)
    ref = j_make(cfg_j, j_mesh(1), n_iters=12)(poses0, p1, e1,
                                              jnp.array([True, True]))

    d = _ba_inputs(cfg_j, edges, poses0, pts0, 12)
    cfg = SlamConfig.from_dict(json.loads(d["cfg"]))
    e, _ = shard_edges_by_point(
        BaEdges(*(torch.from_numpy(d[f]) for f in BaEdges._fields)), L, 1)
    p, _ = stripe_points(torch.from_numpy(d["pts0"]), 1)
    got = make_sharded_ba(cfg, make_mesh(1), n_iters=12)(
        torch.from_numpy(d["poses0"]), p, e, torch.tensor([True, True]))
    for a, b in zip(ref[:2], got[:2]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)
    for a, b in zip(ref[2:], got[2:]):
        np.testing.assert_allclose(float(b), float(a), rtol=1e-5, atol=1e-5)


def test_sharded_ba_two_ranks_matches_jax_mesh(tmp_path):
    """Two gloo ranks against the JAX solver on a 2-device mesh, with the
    JAX test's tolerances (costs, poses within 1 mm / 1 mrad, points to
    groundtruth within 5 mm); the ranks agree exactly on what they share."""
    from boslam_tpu.geometry import se3
    from boslam_tpu.parallel import make_mesh as j_mesh
    from boslam_tpu.parallel.sharded_ba import (
        make_sharded_ba as j_make, shard_edges_by_point as j_shard,
        stripe_points as j_stripe,
    )

    cfg_j, gt_pts, edges, n_pts, poses0, pts0 = _ba_problem(0.03, 0.05)
    L = cfg_j.local_ba.max_local_points
    e2, _ = j_shard(edges, L, 2)
    p2, perm = j_stripe(pts0, 2)
    poses_a, _, c0_a, c1_a = j_make(cfg_j, j_mesh(2), n_iters=12)(
        poses0, p2, e2, jnp.array([True, True]))

    outs = _run_ranks("sharded_ba", 2, tmp_path,
                      _ba_inputs(cfg_j, edges, poses0, pts0, 12))
    for k in ("poses", "cost0", "cost1"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    c0_b, c1_b = float(outs[0]["cost0"]), float(outs[0]["cost1"])
    assert abs(float(c0_a) - c0_b) < 1e-2 * max(float(c0_a), 1.0)
    assert abs(float(c1_a) - c1_b) < 0.05 * max(float(c1_a), 1e-3) + 1e-3
    dr, dt = se3.pose_distance(jnp.asarray(np.asarray(poses_a[:2])),
                               jnp.asarray(outs[0]["poses"][:2]))
    assert float(jnp.max(dt)) < 1e-3 and float(jnp.max(dr)) < 1e-3
    pts_b = np.concatenate([o["pts"] for o in outs])
    np.testing.assert_array_equal(outs[0]["perm"], perm)
    used = np.arange(L)[perm] < n_pts
    err = np.linalg.norm(pts_b - np.asarray(gt_pts)[perm], axis=-1)[used]
    assert err.max() < 5e-3


def test_sharded_ba_converges(tmp_path):
    """The sharded solve over two ranks drives the cost to ~zero (exact
    synthetic problem)."""
    cfg_j, _, edges, _, poses0, pts0 = _ba_problem(0.02, 0.03)
    outs = _run_ranks("sharded_ba", 2, tmp_path,
                      _ba_inputs(cfg_j, edges, poses0, pts0, 15))
    c0, c1 = float(outs[0]["cost0"]), float(outs[0]["cost1"])
    assert c1 < 1e-3 * max(c0, 1.0)


def test_distributed_global_ba_matches_single(tmp_path):
    """Distributed global BA on a LIVE map tracked by the JAX engine, over
    two gloo ranks, against the JAX package's distributed global BA on a
    2-device mesh: the edge count exact, then the JAX test's tolerances
    (cost0 within 1e-2, cost1 < cost0, poses within 2 mm, points within
    5 mm); both ranks return the same whole map."""
    from boslam_tpu.geometry import se3
    from boslam_tpu.io import synthetic
    from boslam_tpu.parallel import make_mesh as j_mesh
    from boslam_tpu.parallel.sharded_global_ba import (
        distributed_global_ba as j_dgba,
    )
    from boslam_tpu.slam import run_sequence as j_run

    d = dict(DP, map=dict(max_keyframes=16, max_points=2048))
    cfg_j, cfg_t = tp.configs(d)
    traj = synthetic.orbit_trajectory(15, radius=0.3, yaw_amplitude=0.15)
    slam = j_run(cfg_j, synthetic.render_sequence(cfg_j.camera, traj))
    assert slam.n_keyframes >= 2
    st_a, (c0_a, c1_a, n_a) = j_dgba(cfg_j, j_mesh(2), slam.map,
                                     lm_iters=5, cg_iters=30)

    outs = _run_ranks("global_ba", 2, tmp_path, dict(
        cfg=json.dumps(d), lm_iters=5, cg_iters=30, **tp.np_dict(slam.map)))
    for k in ("kf_pose", "pt_xyz", "cost0", "cost1", "n_edges"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    out = outs[0]
    assert int(out["n_edges"]) == int(n_a) and int(n_a) > 100
    c0, c1 = float(out["cost0"]), float(out["cost1"])
    assert abs(c0 - float(c0_a)) < 1e-2 * max(float(c0_a), 1.0)
    assert c1 < c0
    _, dt = se3.pose_distance(st_a.kf_pose, jnp.asarray(out["kf_pose"]))
    kv = np.asarray(slam.map.kf_valid)
    assert float(np.max(np.where(kv, np.asarray(dt), 0.0))) < 2e-3
    pv = np.asarray(slam.map.pt_valid)
    perr = np.linalg.norm(np.asarray(st_a.pt_xyz) - out["pt_xyz"], axis=-1)
    assert perr[pv].max() < 5e-3


def test_distributed_runtime_smoke(tmp_path):
    """The bootstrap path in one process: ``maybe_initialize`` joins a
    one-rank group (gloo, file rendezvous) and ``runtime_info`` reports it;
    without a request it does nothing."""
    code = (
        "import os;"
        "from boslam_tpu_torch.parallel.distributed import maybe_initialize,"
        " runtime_info;"
        "assert not maybe_initialize(device='cpu');"
        f"os.environ['BOSLAM_COORDINATOR']='file://{tmp_path}/rdzv';"
        "os.environ['BOSLAM_NUM_PROCESSES']='1';"
        "os.environ['BOSLAM_PROCESS_ID']='0';"
        "assert maybe_initialize(device='cpu'), 'initialize failed';"
        "info = runtime_info();"
        "assert info['initialized'] and info['process_count'] == 1, info;"
        "assert sorted(info) == sorted(['initialized', 'process_index',"
        " 'process_count', 'global_devices', 'local_devices']);"
        "print('DIST_OK', info)"
    )
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BOSLAM_")}
    r = subprocess.run([sys.executable, "-c", code], cwd=tp.ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "DIST_OK" in r.stdout


# --------------------------------------------------------------------------
def _orbits(cam_t, lengths, **kw):
    from boslam_tpu_torch.io import synthetic

    return [synthetic.render_sequence(cam_t, synthetic.orbit_trajectory(
        n, radius=0.25 + 0.05 * s, **kw)) for s, n in enumerate(lengths)]


def _batched_vs_references(d, frame_lists, singles=True):
    """The port's run_sequences (CPU), JAX's run_sequences on a 2-device
    'seq' mesh, and (with ``singles``) the port's single engine per
    sequence."""
    from boslam_tpu.parallel.multi import (
        run_sequences as j_run_sequences, seq_mesh as j_seq_mesh,
    )
    from boslam_tpu_torch.parallel.multi import run_sequences, seq_mesh
    from boslam_tpu_torch.slam import run_sequence

    cfg_j, cfg_t = tp.configs(d)
    n = len(frame_lists)
    got = run_sequences(cfg_t, frame_lists, mesh=seq_mesh(n, ["cpu"]))
    ref = j_run_sequences(cfg_j, frame_lists, mesh=j_seq_mesh(n))
    single = [run_sequence(cfg_t, f, seed=s, chunk=8, device="cpu")
              for s, f in enumerate(frame_lists)] if singles else None
    return got, ref, single


def _hold_batched(got, ref, single, lengths):
    for s, n in enumerate(lengths):
        ts, est = got.trajectory(s)
        _, est_ref = ref.trajectory(s)
        _, est_one = single[s].trajectory()
        assert len(ts) == len(got.metrics[s]) == n
        np.testing.assert_allclose(est, est_ref, rtol=0, atol=POSE_ATOL_M)
        assert [m.get("event") for m in got.metrics[s]] == \
            [m.get("event") for m in ref.metrics[s]]
        assert got.n_keyframes(s) == ref.n_keyframes(s)
        # One more or fewer tracking inlier moves the count of new points.
        assert abs(got.n_points(s) - ref.n_points(s)) <= \
            0.02 * ref.n_points(s)
        np.testing.assert_array_equal(est, est_one)
        assert got.n_keyframes(s) == single[s].n_keyframes
        assert got.n_points(s) == single[s].n_points


def test_batched_engine_matches_single_engine():
    """Two sequences of 12 frames: each within the engine tolerance of JAX's
    batched run with its keyframe events and counts, and equal bit for bit
    to the port's single engine on the same frames."""
    cfg_j, cfg_t = tp.configs(DP)
    frame_lists = _orbits(cfg_t.camera, [12, 12], yaw_amplitude=0.1)
    got, ref, single = _batched_vs_references(DP, frame_lists)
    _hold_batched(got, ref, single, [12, 12])


def test_batched_engine_depth_stride_matches_single_engine():
    """depth_wire_stride=2: the batched feed reduces full-resolution depth
    to the wire per frame, as the single engine does."""
    d = dict(DP, camera=dict(DP["camera"], depth_wire_stride=2))
    cfg_j, cfg_t = tp.configs(d)
    frame_lists = _orbits(cfg_t.camera, [6, 6])
    assert frame_lists[0][0][2].shape == (120, 160)
    got, ref, single = _batched_vs_references(d, frame_lists)
    _hold_batched(got, ref, single, [6, 6])


def test_batched_engine_unequal_lengths():
    """Lengths 12 and 7: each sequence runs to its own end, a finished
    sequence leaves no record and does no work (its frame-step syncs stop),
    and each matches JAX's batched run and the port's single engine."""
    cfg_j, cfg_t = tp.configs(DP)
    frame_lists = _orbits(cfg_t.camera, [12, 7], yaw_amplitude=0.1)
    got, ref, single = _batched_vs_references(DP, frame_lists)
    _hold_batched(got, ref, single, [12, 7])
    assert [len(m) for m in ref.metrics] == [12, 7]
    assert got.sync[1].count == single[1].sync.count


def test_batched_events_train_vocab_like_jax():
    """A batched run whose flushes train the vocabulary (after 3 keyframes,
    refreshed every 2) and verify loop candidates, closing one: the
    per-sequence records' events and verifications, the closures, when the
    vocabulary was trained (and 98% of its words) and the trajectories
    match JAX's batched run."""
    d = dict(DP, loop=dict(vocab_train_kf=3, vocab_refresh_kf=2,
                           min_gap_kf=1, consistency=1, min_score_matches=5),
             tracker=dict(kf_min_interval=1, kf_max_interval=2))
    cfg_j, cfg_t = tp.configs(d)
    frame_lists = _orbits(cfg_t.camera, [20, 14], yaw_amplitude=0.2)
    got, ref, _ = _batched_vs_references(d, frame_lists, singles=False)
    for s in range(2):
        assert got._vocab_trained_at[s] == ref._vocab_trained_at[s] >= 3
        assert bool(got.loop[s].vocab_ready)
        assert [(m.get("event"), "loop_inliers" in m) for m in got.metrics[s]] \
            == [(m.get("event"), "loop_inliers" in m) for m in ref.metrics[s]]
        assert got.n_loops_closed[s] == ref.n_loops_closed[s]
        _, est = got.trajectory(s)
        _, est_ref = ref.trajectory(s)
        np.testing.assert_allclose(est, est_ref, rtol=0, atol=POSE_ATOL_M)
        # Trained on maps whose descriptors part at a few keypoints.
        same = np.all(got.loop[s].vocab.numpy().view(np.uint32)
                      == np.asarray(ref.loop.vocab[s]), axis=1)
        assert same.mean() >= 0.98, same.mean()
    assert any("loop_inliers" in m for ms in got.metrics for m in ms)


def test_cli_distributed_global_ba(tmp_path):
    """``--distributed --global-ba`` on two gloo ranks at 160x120: both
    ranks shard the exit global BA over pt=2 and write the same
    trajectory, ATE below 5 cm."""
    code = (
        "import sys, dataclasses, boslam_tpu_torch.config as C;"
        f"C.TUM_FR1 = dataclasses.replace(C.TUM_FR1, **{tp.TUM_MINI_CAM!r});"
        "from boslam_tpu_torch.main import main;"
        "sys.argv = ['main', '--synthetic', '16', '--device', 'cpu',"
        " '--out', sys.argv[1], '--distributed', '--global-ba']; main()"
    )
    procs = []
    for r in range(2):
        env = dict(os.environ, BOSLAM_COORDINATOR=f"file://{tmp_path}/rdzv",
                   BOSLAM_NUM_PROCESSES="2", BOSLAM_PROCESS_ID=str(r),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(tmp_path / f"traj{r}.txt")],
            cwd=tp.ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "[distributed] {'initialized': True" in err
        assert "global BA sharded over pt=2 devices" in err, err[-2000:]
        summary = json.loads(out.strip().splitlines()[-1])
        assert summary["ate_rmse_m"] < 0.05, summary
        assert summary["frames"] == 16
    a, b = ((tmp_path / f"traj{r}.txt").read_text() for r in range(2))
    assert a == b
