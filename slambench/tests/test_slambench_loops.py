"""The loop cell's pieces on the CPU: the float64 essential graph and its
solve against the program's, the mix's ``prefix`` and ``render_seed``,
the configuration's ``engine`` keywords, and the spans a traced run
keeps."""

import time

import numpy as np
import pytest
import torch

import core
import frames
from reference import pose_graph as ref_pg
from reference.geometry import exp, pose_compose, pose_inv

CPU = torch.device("cpu")


def _closure_map(seed, K=12, dead=5):
    """A map of K keyframe slots (one dead) on a drifting chain, its
    spanning tree along the chain, covisibility weights on three levels
    around the essential threshold (ties and the 4 K cut both bite), and
    one loop edge from the last keyframe onto the second, measured at the
    true poses: (cfg, map, kf_id, cand)."""
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.mapping.map_state import empty_map

    slam_cfg = core.load_json("configs", "tum_vga512")["slam"]
    cfg = SlamConfig.from_dict(dict(slam_cfg, map=dict(slam_cfg["map"],
                                                       max_keyframes=K)))
    g = torch.Generator().manual_seed(seed)
    steps = torch.randn(K, 6, generator=g, dtype=torch.float64) * torch.tensor(
        [0.15, 0.15, 0.15, 0.4, 0.4, 0.4], dtype=torch.float64)
    drift = torch.randn(K, 6, generator=g, dtype=torch.float64) * 0.01
    true = [exp(steps[0])]
    est = [true[0]]
    for k in range(1, K):
        true.append(pose_compose(exp(steps[k]), true[-1]))
        est.append(pose_compose(exp(steps[k] + drift[k]), est[-1]))
    true, est = torch.stack(true), torch.stack(est)
    valid = torch.ones(K, dtype=torch.bool)
    valid[dead] = False
    live = torch.nonzero(valid)[:, 0]
    parent = torch.full((K,), -1, dtype=torch.int32)
    parent[live[1:]] = live[:-1].to(torch.int32)
    levels = torch.tensor([60, 100, 150, 150, 200], dtype=torch.int32)
    c = levels[torch.randint(0, 5, (K, K), generator=g)]
    covis = torch.triu(c, 1) + torch.triu(c, 1).T
    kf_id, cand = int(live[-1]), int(live[1])
    m = empty_map(cfg, CPU)
    rel = pose_compose(true[kf_id], pose_inv(true[cand]))
    m = m._replace(
        kf_pose=est.float(), kf_valid=valid, spanning_parent=parent,
        covis=covis, n_loop_edges=torch.tensor(1, dtype=torch.int32),
        loop_edges=m.loop_edges.index_put((torch.tensor(0),), torch.tensor(
            [kf_id, cand], dtype=torch.int32)),
        loop_rel=m.loop_rel.index_put((torch.tensor(0),), rel.float()))
    return cfg, m, kf_id, cand


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_reference_pose_graph_is_the_programs(seed):
    """The reference works out the program's essential graph (the same
    edges) and reaches the same objective from the same closure.  The
    tolerance is float32's: the program's residuals are float32 logs of
    poses ~1-3 m from the origin (rounding ~1e-7 m), so its solution sits
    off the float64 one by ~1e-6 of a pose, and the objective, flat at the
    optimum, differs by ~1e-7-1e-6 of itself."""
    from boslam_tpu_torch.solvers.pose_graph import (
        build_essential_edges, optimize_pose_graph,
    )

    cfg, m, kf_id, cand = _closure_map(seed)
    edges = build_essential_edges(cfg, m)
    init = m.kf_pose.clone()
    init[kf_id] = pose_compose(m.loop_rel[0].double(),
                               m.kf_pose[cand].double()).float()
    fixed = torch.zeros(m.kf_pose.shape[0], dtype=torch.bool)
    fixed[0] = fixed[cand] = True
    out = optimize_pose_graph(cfg, init, m.kf_valid, edges, fixed)

    arrays = {k: getattr(m, k) for k in ("kf_pose", "kf_valid",
                                         "spanning_parent", "covis",
                                         "loop_edges", "loop_rel",
                                         "n_loop_edges")}
    g, start, ref = ref_pg.loop_solve(arrays, kf_id, cand, m.loop_rel[0],
                                      cfg.map.covis_essential_weight,
                                      cfg.loop.pg_iters)
    live = edges.valid & (edges.weight != 0)
    prog_pairs = sorted(zip(edges.i[live].tolist(), edges.j[live].tolist()))
    assert prog_pairs == sorted(zip(g.i.tolist(), g.j.tolist()))
    assert sorted(edges.weight[live].tolist()) == sorted(g.w.tolist())
    assert len(prog_pairs) < 11 + 4 * 12 + 1  # the top-4K cut dropped pairs
    f0, f_ref = float(ref_pg.objective(g, start)), float(ref_pg.objective(g, ref))
    f_prog = float(ref_pg.objective(g, out.double()))
    assert f_ref < 0.1 * f0
    assert abs(f_prog - f_ref) / f_ref < 1e-5, (f0, f_prog, f_ref)


def test_loop_probe_values_are_missing_without_a_closure():
    import boslam_tpu_torch.slam as slam
    import boslam_tpu_torch.solvers.pose_graph as pg

    import loops

    orig = (slam.close_loop_update, pg.build_essential_edges)
    probe = loops.PoseGraphProbe(slam, pg)
    assert probe.values({}, CPU) == {}
    probe.close()
    assert (slam.close_loop_update, pg.build_essential_edges) == orig


def _spec(cell, **traffic):
    spec = core.cell(cell)
    spec["traffic_spec"] = dict(spec["traffic_spec"], **traffic)
    return spec


def _setup(spec, seed, trace=False):
    return frames.setup(spec, seed=seed, trace=trace, device=CPU,
                        rehearsal=True)


def test_prefix_and_render_seed_cut_and_fix_the_frames():
    from render import trajectory

    reh = {"frames": 400, "stride": 40, "warmup_frames": 1}
    a = _setup(_spec("hall.loop", rehearsal=reh), 2**31 + 5)
    b = _setup(_spec("hall.loop", rehearsal=reh), 11)
    path = trajectory(core.load_json("traffic", "loop_replay_chunk1")["path"])
    assert len(a.frames) == 8  # frames 0, 40, ..., 280 of the first 320
    assert np.array_equal(a.truth.poses_twc, path.poses_twc[:320:40])
    assert all(np.array_equal(x[2], y[2]) for x, y in zip(a.frames, b.frames))
    free = {k: v for k, v in core.load_json(
        "traffic", "loop_replay_chunk1").items() if k != "render_seed"}
    c = _setup(dict(core.cell("hall.loop"), traffic_spec=dict(
        free, rehearsal=reh)), 11)
    assert not np.array_equal(b.frames[1][2], c.frames[1][2])
    assert np.array_equal(b.frames[1][1], c.frames[1][1])  # the same image


def test_engine_options_reach_the_engine():
    spec = core.cell("hall.live")
    spec["config_spec"] = dict(spec["config_spec"],
                               engine={"async_mapping": True})
    st = _setup(spec, 3)
    slam = st.make_engine()
    assert slam.async_mapping and slam.mapping_device == CPU
    win = frames.window(st, 0, min_frames=len(st.frames))
    assert win.complete == 1 and len(win.timed) == len(st.frames)
    assert any("ba_cost1" in r for _, r, _ in win.timed if "kf_id" in r)
    spec["config_spec"]["engine"] = {"mapping_device": "card"}
    slam = _setup(spec, 3).make_engine()
    assert slam.async_mapping and slam.mapping_device == CPU
    for bad in ({"mapping_device": "cuda:1"}, {"chunk": 4}):
        with pytest.raises(ValueError):
            frames.engine_options({"engine": bad}, CPU)
    assert frames.engine_options({}, CPU) == {}


@pytest.mark.parametrize("trace", [False, True])
def test_traced_runs_keep_the_windows_spans(trace):
    res = frames.run(core.cell("hall.live"), seed=2**31 + 9, seconds=0,
                     trace=trace, device=CPU, rehearsal=True, control=None,
                     t_start=time.perf_counter())
    assert res["values"]["kp_mismatch"] == 0
    if not trace:
        assert "spans" not in res["run"]
        return
    spans = res["run"]["spans"]
    names = {name for _, name, _ in spans}
    assert {"frame", "frame.frontend", "frame.track", "flush"} <= names
    frame_pos = sorted(p for p, name, _ in spans if name == "frame")
    assert frame_pos == list(range(res["attempted"]))
    assert all(ms >= 0 for _, _, ms in spans)
    assert core.metric_module("loop_close_ms_p50").read(res["run"]) is None
    res["run"]["spans"] = spans + [(7, "flush.close_loop", 120.0),
                                   (9, "flush.close_loop", 80.0)]
    assert core.metric_module("loop_close_ms_p50").read(res["run"]) == 100.0
