"""The port's utilities against the JAX package's: checkpoint / resume
(tests/test_utils.py's four checkpoint tests, as port tests, plus a save
during a pending async solve), the metric summary, JSONL and TensorBoard
export, the map view, ``SlamConfig.from_yaml``, and the CLI flags that use
them (``--checkpoint-every/--checkpoint-dir/--resume``, ``--metrics``,
``--metrics-tb``, ``--profile``, ``--viz``)."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import _torch_parity as tp
from boslam_tpu_torch.config import SlamConfig, TUM_FR2
from boslam_tpu_torch.io import synthetic, tum
from boslam_tpu_torch.slam import SlamSystem
from boslam_tpu_torch.utils import checkpoint as ckpt
from boslam_tpu_torch.utils import metrics as port_metrics

# The configuration of tests/test_utils.py.
CFG = SlamConfig.from_dict(dict(
    camera=dict(width=160, height=120, fx=70.0, fy=70.0, cx=80.0, cy=60.0),
    orb=dict(n_features=128, n_levels=3)))

RECORDS = [
    {"ts": 0.0, "event": "init", "dt_ms": 5.0},
    {"ts": 0.1, "n_inliers": 50, "n_matches": 80, "dt_ms": 7.0},
    {"ts": 0.2, "n_inliers": 60, "event": "keyframe", "ba_cost0": 9.0,
     "ba_cost1": 3.0, "ba_edges": 40, "dt_ms": 9.0},
    {"ts": 0.3, "n_inliers": 10, "lost": True, "dt_ms": 6.0},
    {"ts": 0.4, "n_inliers": 0, "event": "relocalize", "reloc_ok": True},
    {"ts": 0.5, "n_inliers": 70, "event": "loop_closed", "loop_score": 0.4,
     "loop_inliers": 33, "dt_ms": 11.0},
]


@pytest.fixture(scope="module")
def frames():
    return synthetic.render_sequence(
        CFG.camera, synthetic.orbit_trajectory(10, radius=0.3))


def _engine(frames, n, **kw):
    slam = SlamSystem(CFG, device="cpu", **kw)
    for f in frames[:n]:
        slam.process_frame(*f)
    return slam


def test_checkpoint_roundtrip(tmp_path, frames):
    """A snapshot with a cull-chain record restores map, trajectory, cull
    chain, generator state and host mirror; the resumed engine keeps
    tracking."""
    slam = _engine(frames, 8)
    slam.cull_chain[(3, 3)] = (0, 0, np.asarray(
        [1.0, 0, 0, 0, 0.1, 0.2, 0.3], np.float32))
    path = str(tmp_path / "ckpt")
    ckpt.save(path, slam)

    slam2 = SlamSystem(CFG, device="cpu", seed=5)
    ckpt.restore(path, slam2)
    assert slam2.n_keyframes == slam.n_keyframes >= 2
    assert slam2.n_points == slam.n_points
    assert slam2.cull_chain[(3, 3)][:2] == (0, 0)
    np.testing.assert_array_equal(slam2.cull_chain[(3, 3)][2],
                                  slam.cull_chain[(3, 3)][2])
    for k, v in slam.map._asdict().items():
        assert torch.equal(getattr(slam2.map, k), v), k
    for k, v in slam.loop._asdict().items():
        assert torch.equal(getattr(slam2.loop, k), v), k
    for k, v in slam.track._asdict().items():
        assert torch.equal(getattr(slam2.track, k), v), k
    assert torch.equal(slam2.generator.get_state(), slam.generator.get_state())
    np.testing.assert_array_equal(np.stack(slam2.poses_twc),
                                  np.stack(slam.poses_twc))
    assert slam2.timestamps == slam.timestamps
    assert [r[:2] for r in slam2.frame_refs] == [r[:2] for r in slam.frame_refs]
    assert slam2._kf_seq_host == slam._kf_seq_host
    assert slam2._vocab_trained_at == slam._vocab_trained_at

    # The resumed engine keeps tracking, as the original does.
    slam2.process_frame(*frames[8])
    slam.process_frame(*frames[8])
    assert not slam2.metrics[-1]["lost"]
    np.testing.assert_array_equal(slam2.poses_twc[-1], slam.poses_twc[-1])


def test_checkpoint_restore_fills_missing_fields(tmp_path, frames):
    """A snapshot without a MapState field restores that field at its
    ``empty_map`` default."""
    slam = _engine(frames, 6)
    path = str(tmp_path / "old")
    ckpt.save(path, slam)
    state = torch.load(os.path.join(path, ckpt.STATE_FILE), weights_only=True)
    del state["map"]["kf_seq"]
    os.makedirs(tmp_path / "new")
    torch.save(state, tmp_path / "new" / ckpt.STATE_FILE)

    slam2 = SlamSystem(CFG, device="cpu")
    ckpt.restore(str(tmp_path / "new"), slam2)
    assert slam2.n_keyframes == slam.n_keyframes
    assert int(torch.max(slam2.map.kf_seq)) == -1


def test_checkpoint_restore_rejects_mismatched_capacities(tmp_path, frames):
    slam = _engine(frames, 6)
    path = str(tmp_path / "cap")
    ckpt.save(path, slam)
    other = CFG.replace(
        map=dataclasses.replace(CFG.map, max_keyframes=CFG.map.max_keyframes * 2))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, SlamSystem(other, device="cpu"))


def test_checkpoint_save_lands_a_pending_async_solve(tmp_path, frames):
    """``save`` during a pending deferred local BA merges it first: the
    snapshot holds the refined map and the solves' stats reach their
    records."""
    slam = SlamSystem(CFG, device="cpu", chunk=4, async_mapping=True)
    for f in frames[:8]:
        slam.feed(*f)
    assert slam._pending_ba is not None
    recs = [rec for _, _, rec in slam._pending_ba.solves]
    before = slam.map.kf_pose.clone()
    path = str(tmp_path / "async")
    ckpt.save(path, slam)
    assert slam._pending_ba is None
    assert all(r["ba_edges"] > 0 and r["ba_cost1"] <= r["ba_cost0"] for r in recs)
    assert not torch.equal(slam.map.kf_pose, before)
    slam2 = SlamSystem(CFG, device="cpu", async_mapping=True)
    ckpt.restore(path, slam2)
    assert torch.equal(slam2.map.kf_pose, slam.map.kf_pose)
    assert torch.equal(slam2.map.pt_xyz, slam.map.pt_xyz)


def test_metrics_summary_and_jsonl_match_jax(tmp_path):
    from boslam_tpu.utils import metrics as j_metrics

    assert port_metrics.summarize(RECORDS) == j_metrics.summarize(RECORDS)
    assert port_metrics.summarize([]) == j_metrics.summarize([])
    port_metrics.dump_metrics(str(tmp_path / "p.jsonl"), RECORDS)
    j_metrics.dump_metrics(str(tmp_path / "j.jsonl"), RECORDS)
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    lines = [json.loads(line) for line in open(tmp_path / "p.jsonl")]
    assert lines == RECORDS
    w = port_metrics.JsonlWriter(str(tmp_path / "w.jsonl"))
    for m in RECORDS:
        w.write(m)
    w.close()
    assert (tmp_path / "w.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()


def _tb_values(logdir):
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader,
    )

    files = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    assert len(files) == 1
    out = set()
    for e in EventFileLoader(files[0]).Load():
        for v in (e.summary.value if e.summary else []):
            val = v.tensor.float_val[0] if v.HasField("tensor") else v.simple_value
            out.add((v.tag, e.step, e.wall_time, val))
    return out


def test_tensorboard_export_matches_jax(tmp_path):
    from boslam_tpu.utils.metrics import export_tensorboard as j_export

    port_metrics.export_tensorboard(str(tmp_path / "p"), RECORDS)
    j_export(str(tmp_path / "j"), RECORDS)
    got, want = _tb_values(str(tmp_path / "p")), _tb_values(str(tmp_path / "j"))
    assert got == want
    assert ("frame/n_inliers", 1, 0.1, 50.0) in got
    assert any(t == "event/keyframe" and s == 2 and v == 1.0 for t, s, _, v in got)


def test_viewer_renders_png(tmp_path):
    """``render_map`` draws a live MapState into a PNG over 10 KB."""
    from boslam_tpu_torch.mapping.map_state import empty_map
    from boslam_tpu_torch.viz import render_map

    cfg = SlamConfig.from_dict(dict(map=dict(max_keyframes=8, max_points=256),
                                    orb=dict(n_features=64)))
    st = empty_map(cfg, "cpu")
    rng = np.random.default_rng(0)
    kf_valid = st.kf_valid.clone()
    kf_valid[0] = True
    st = st._replace(
        pt_xyz=torch.from_numpy(rng.uniform(-1, 1, (256, 3)).astype(np.float32)),
        pt_valid=torch.ones(256, dtype=torch.bool), kf_valid=kf_valid)
    traj = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (5, 1))
    traj[:, 4] = np.linspace(0, 1, 5)
    out = render_map(st, trajectory=traj, groundtruth=traj,
                     out_path=str(tmp_path / "m.png"))
    assert os.path.getsize(out) > 10000


def test_config_from_yaml(tmp_path):
    """Sections override the base preset, capacities included; unknown
    sections and keys raise (tests/test_utils.py:151)."""
    p = tmp_path / "cfg.yaml"
    p.write_text(
        "map:\n  max_keyframes: 64\n  max_points: 4096\n"
        "orb:\n  n_features: 256\n"
        "camera:\n  fx: 333.0\n"
    )
    cfg = SlamConfig.from_yaml(str(p), base=SlamConfig(camera=TUM_FR2))
    assert cfg.map.max_keyframes == 64
    assert cfg.map.max_points == 4096
    assert cfg.orb.n_features == 256
    assert cfg.camera.fx == 333.0
    assert cfg.camera.fy == TUM_FR2.fy
    assert cfg.orb.n_levels == 8

    bad = tmp_path / "bad.yaml"
    bad.write_text("mapp:\n  max_keyframes: 64\n")
    with pytest.raises(ValueError, match="unknown config sections"):
        SlamConfig.from_yaml(str(bad))
    bad2 = tmp_path / "bad2.yaml"
    bad2.write_text("map:\n  max_keyframez: 64\n")
    with pytest.raises(TypeError):
        SlamConfig.from_yaml(str(bad2))


def test_cli_checkpoint_resume_metrics_profile_viz(tmp_path):
    """The CLI on tum_mini with ``--async-mapping --checkpoint-every 1
    --metrics --metrics-tb --profile --viz``: one JSONL line per frame, a
    TensorBoard event file, a trace in the profile dir, a PNG and a
    checkpoint; then ``--resume`` from it: as the reference's CLI does, the
    restored engine is fed the sequence again from its first frame, loses
    none, and writes the checkpoint's poses followed by the new ones."""
    ck, prof, tb = tmp_path / "ck", tmp_path / "prof", tmp_path / "tb"
    common = ("--tum", tp.TUM_MINI, "--device", "cpu", "--async-mapping")
    res = tp.run_cli(*common, "--out", tmp_path / "a.txt",
                     "--checkpoint-every", 1, "--checkpoint-dir", ck,
                     "--metrics", tmp_path / "m.jsonl", "--metrics-tb", tb,
                     "--profile", prof, "--viz", tmp_path / "map.png")
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["n_frames"] == summary["frames"] == 6
    assert summary["lost"] == 0 and summary["ate_rmse_m"] < 0.05
    lines = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    assert len(lines) == 6 and lines[0]["event"] == "init"
    assert glob.glob(str(tb / "events.out.tfevents.*"))
    (trace_file,) = glob.glob(str(prof / "*.pt.trace.json"))
    # The engine's spans beside the trace, on its clock: each host
    # operation the profiler recorded ran inside a span of the engine's.
    trace = json.load(open(trace_file))
    spans = json.load(open(prof / "spans.json"))
    assert spans["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    assert {e["args"]["request"] for e in spans["traceEvents"]
            if e["name"] == "frame"} == set(range(6))
    around = [(e["ts"], e["ts"] + e["dur"]) for e in spans["traceEvents"]
              if e["name"] in ("frame", "flush")]
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    inside = [any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                  for a, b in around) for e in ops]
    assert ops and sum(inside) >= 0.9 * len(ops)
    assert os.path.getsize(tmp_path / "map.png") > 10000
    assert (ck / ckpt.STATE_FILE).exists()

    saved = torch.load(ck / ckpt.STATE_FILE, weights_only=True)
    n_saved = saved["poses_twc"].shape[0]
    assert 1 <= n_saved < 6
    res = tp.run_cli(*common, "--out", tmp_path / "b.txt", "--resume", ck,
                     "--metrics", tmp_path / "m2.jsonl")
    assert f"resumed from {ck}" in res.stderr
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["frames"] == n_saved + 6 and summary["lost"] == 0
    assert summary["n_frames"] == 6
    assert len(open(tmp_path / "m2.jsonl").readlines()) == 6
    assert summary["ate_rmse_m"] < 0.05
    ts_a, first = tum.load_trajectory(str(tmp_path / "a.txt"))
    ts_b, resumed = tum.load_trajectory(str(tmp_path / "b.txt"))
    assert first.shape == (6, 7) and resumed.shape == (n_saved + 6, 7)
    np.testing.assert_array_equal(ts_b[:n_saved], ts_a[:n_saved])
    np.testing.assert_array_equal(ts_b[n_saved:], ts_a)
