"""Local-mapping parity of the port: every map_ops step of the inline
keyframe event, one by one, the map_state helpers and local BA, on a JAX map
carried over by ``convert``.  Integer and bool fields exact, float fields
within atol 1e-5, and ``pt_dir_sum`` (fed by a scatter-add whose duplicate
order differs between backends) within atol 1e-4.  Local BA: costs within
rtol 1e-4 and keyframe poses within atol 1e-4 (float32 Gauss-Newton with
another summation order)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import _torch_parity as tp
from boslam_tpu.mapping import map_ops as j_ops
from boslam_tpu.mapping import map_state as j_ms
from boslam_tpu.tracking.tracker import track_frame as j_track_frame
from boslam_tpu_torch import convert
from boslam_tpu_torch.mapping import map_ops, map_state

SCATTER_ADD = ("pt_dir_sum",)


def _slot(x) -> torch.Tensor:
    return torch.tensor(int(x), dtype=torch.int32)


@pytest.fixture(scope="module")
def event():
    """The JAX keyframe event of frame 8 of the orbit, step by step: the
    state before each step and the step's JAX result."""
    cfg_j, cfg_t, slam, feats = tp.scenario(tp.SMALL, 8)
    tr, out = j_track_frame(cfg_j, slam.map, slam.track, feats)
    assert bool(out.need_kf) and not bool(out.lost)
    s0 = slam.map
    s1 = j_ops.update_track_stats(cfg_j, s0, out.visible, out.match_pt, out.match_ok)
    s2, evict_info = j_ops.evict_for_slot(cfg_j, s1)
    s3, kf_id = j_ops.insert_keyframe(cfg_j, s2, feats, out.pose_cw, out.match_pt,
                                      out.match_ok, tr.frame_idx)
    s4 = j_ops.fuse_new_keyframe(cfg_j, s3, kf_id)
    s5 = j_ops.refresh_point_model(cfg_j, s4, kf_id)
    s6 = j_ops.cull_points(cfg_j, s5, update_covis=False)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, feats=feats, tr=tr, out=out,
                states=[s0, s1, s2, s3, s4, s5, s6], evict_info=evict_info,
                kf_id=int(kf_id))


def _port(ms):
    return tp.port_state(ms, convert.map_state_from_numpy)


def test_update_track_stats_matches_jax(event):
    out = event["out"]
    got = map_ops.update_track_stats(
        event["cfg_t"], _port(event["states"][0]), tp.t(out.visible),
        tp.t(out.match_pt), tp.t(out.match_ok))
    tp.assert_state_close(event["states"][1], got)


def test_evict_for_slot_with_a_free_slot_is_a_no_op(event):
    got, info = map_ops.evict_for_slot(event["cfg_t"], _port(event["states"][1]))
    assert float(event["evict_info"][0]) == -1.0
    np.testing.assert_allclose(info.numpy(), np.asarray(event["evict_info"]),
                               atol=1e-5)
    tp.assert_state_close(event["states"][2], got)


def test_insert_keyframe_matches_jax(event):
    out, tr = event["out"], event["tr"]
    f_t = tp.port_state(event["feats"], convert.frame_features_from_numpy)
    got, kf_id = map_ops.insert_keyframe(
        event["cfg_t"], _port(event["states"][2]), f_t, tp.t(out.pose_cw),
        tp.t(out.match_pt), tp.t(out.match_ok), tp.t(tr.frame_idx))
    assert int(kf_id) == event["kf_id"]
    tp.assert_state_close(event["states"][3], got, loose=SCATTER_ADD)


@pytest.mark.parametrize("step", ["fuse", "refresh", "cull_points"])
def test_keyframe_event_step_matches_jax(event, step):
    cfg_t, kf = event["cfg_t"], _slot(event["kf_id"])
    i, fn = {
        "fuse": (4, lambda s: map_ops.fuse_new_keyframe(cfg_t, s, kf)),
        "refresh": (5, lambda s: map_ops.refresh_point_model(cfg_t, s, kf)),
        "cull_points": (6, lambda s: map_ops.cull_points(cfg_t, s, update_covis=False)),
    }[step]
    before, want = event["states"][i - 1], event["states"][i]
    got = fn(_port(before))
    tp.assert_state_close(want, got, loose=SCATTER_ADD)
    if step == "fuse":  # the step did real work on this map
        assert not np.array_equal(np.asarray(want.kf_obs_pt),
                                  np.asarray(before.kf_obs_pt))


@pytest.mark.parametrize("name", ["free_kf_slot", "latest_kf_slot", "incidence",
                                  "recompute_covis", "point_obs_count",
                                  "covis_neighbors"])
def test_map_state_helpers_match_jax(event, name):
    ms_j = event["states"][4]
    ms_t = _port(ms_j)
    if name == "covis_neighbors":
        ref = j_ms.covis_neighbors(ms_j, event["kf_id"], 4, 15)
        got = map_state.covis_neighbors(ms_t, _slot(event["kf_id"]), 4, 15)
    elif name == "recompute_covis":
        ref = (j_ms.recompute_covis(ms_j).covis,)
        got = (map_state.recompute_covis(ms_t).covis,)
    else:
        ref = getattr(j_ms, name)(ms_j)
        got = getattr(map_state, name)(ms_t)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(r, np.float32))


@pytest.fixture(scope="module")
def saturated():
    """A full pool of 9 keyframe slots (the fewest that local BA and the
    point refresh take): the orbit's keyframes of frames 0, 4 and 8, then
    frame 12 inserted until no slot is free.  The copies observe the same
    points, so both the eviction and the redundancy cull find a victim."""
    d = dict(tp.E2E, map=dict(max_keyframes=9, max_points=4096))
    cfg_j, cfg_t, slam, feats = tp.scenario(d, 12)
    tr, out = j_track_frame(cfg_j, slam.map, slam.track, feats)
    ms, slot = j_ops.insert_keyframe(cfg_j, slam.map, feats, out.pose_cw,
                                     out.match_pt, out.match_ok, tr.frame_idx)
    obs = ms.kf_obs_pt[slot]
    while not bool(np.all(np.asarray(ms.kf_valid))):
        ms, _ = j_ops.insert_keyframe(cfg_j, ms, feats, out.pose_cw, obs,
                                      obs >= 0, tr.frame_idx)
    return cfg_j, cfg_t, ms


@pytest.mark.parametrize("op", ["evict_for_slot", "cull_one_keyframe"])
def test_keyframe_removal_matches_jax(saturated, op):
    cfg_j, cfg_t, ms_j = saturated
    ref_state, ref_info = getattr(j_ops, op)(cfg_j, ms_j)
    got_state, got_info = getattr(map_ops, op)(cfg_t, _port(ms_j))
    assert float(ref_info[0]) >= 0  # a keyframe really goes
    np.testing.assert_allclose(got_info.numpy(), np.asarray(ref_info), atol=1e-5)
    tp.assert_state_close(ref_state, got_state)


# ---- local BA ---------------------------------------------------------------

BA_COST_RTOL = 1e-4
BA_POSE_ATOL = 1e-4


def test_local_ba_window_and_problem_match_jax(event):
    from boslam_tpu.solvers import local_ba as j_lba
    from boslam_tpu_torch.solvers import local_ba

    ms_j, kf = event["states"][6], event["kf_id"]
    ms_t = _port(ms_j)
    ref = j_lba._select_window(event["cfg_j"], ms_j, jnp.int32(kf))
    got = local_ba._select_window(event["cfg_t"], ms_t, _slot(kf))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    ref = j_lba._build_problem(event["cfg_j"], ms_j, jnp.int32(kf))
    got = local_ba._build_problem(event["cfg_t"], ms_t, _slot(kf))
    # (cam_ids, cam_mask, opt_cam_mask, poses, local_ids, slot_used, pts, edges)
    for i in range(7):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    for k in ref[7]._fields:
        np.testing.assert_allclose(getattr(got[7], k).numpy(),
                                   np.asarray(getattr(ref[7], k)), atol=1e-6, err_msg=k)
    assert int(np.asarray(ref[7].valid).sum()) > 300


def test_local_bundle_adjustment_matches_jax(event):
    from boslam_tpu.solvers.local_ba import local_bundle_adjustment as j_local_ba
    from boslam_tpu_torch.solvers.local_ba import local_bundle_adjustment

    ms_j, kf = event["states"][6], event["kf_id"]
    ref_state, ref = j_local_ba(event["cfg_j"], ms_j, jnp.int32(kf))
    got_state, got = local_bundle_adjustment(event["cfg_t"], _port(ms_j), _slot(kf))
    assert float(ref.cost1) < float(ref.cost0)
    np.testing.assert_allclose(float(got.cost0), float(ref.cost0), rtol=BA_COST_RTOL)
    np.testing.assert_allclose(float(got.cost1), float(ref.cost1), rtol=BA_COST_RTOL)
    assert int(got.n_edges) == int(ref.n_edges)
    assert int(got.n_points) == int(ref.n_points)
    np.testing.assert_allclose(got_state.kf_pose.numpy(), np.asarray(ref_state.kf_pose),
                               atol=BA_POSE_ATOL)
    np.testing.assert_allclose(got_state.pt_xyz.numpy(), np.asarray(ref_state.pt_xyz),
                               atol=1e-5)


def _graph_cfg(section=None, field=None, value=None):
    from boslam_tpu_torch.config import SlamConfig

    d = {"map": dict(max_keyframes=16, max_points=1024)}
    if section is not None:
        d[section] = dict(d.get(section, {}), **{field: value})
    return SlamConfig.from_dict(d)


@pytest.mark.parametrize("section, field, value, same", [
    ("camera", "fx", 300.0, False),
    ("camera", "cy", 100.0, False),
    ("local_ba", "lm_lambda0", 2e-4, False),
    ("local_ba", "max_local_points", 1024, False),
    ("tracker", "depth_weight", 2.0, False),
    ("orb", "scale_factor", 1.3, False),
    ("map", "max_points", 2048, False),  # another pool: other shapes
    (None, None, None, True),
    ("loop", "vocab_size", 512, True),   # read by no solve
    ("camera", "width", 320, True),
])
def test_graph_key_follows_every_baked_in_value(section, field, value, same):
    """Two configurations share an inline graph exactly when every value
    its capture bakes in is equal."""
    from boslam_tpu_torch.solvers import local_ba

    def key(cfg):
        return local_ba.graph_key(cfg, map_state.empty_map(cfg, "cpu"),
                                  local_ba.SOLVE_FIELDS)

    base, other = _graph_cfg(), _graph_cfg(section, field, value)
    assert (key(other) == key(base)) is same
    assert key(other) == key(_graph_cfg(section, field, value))


def test_local_bundle_adjustment_on_the_cpu_builds_no_graph(event):
    """A CPU map runs the eager solve: no capture, no replay, no cache
    entry; the solve's own poses and points land in their slots, and the
    other fields are the input's own tensors."""
    from boslam_tpu_torch.ops import build
    from boslam_tpu_torch.solvers import local_ba

    cfg, kf = event["cfg_t"], _slot(event["kf_id"])
    state = _port(event["states"][6])
    graphs, launches = dict(local_ba._INLINE_GRAPHS), dict(build.LAUNCHES)
    assert local_ba.inline_graph(cfg, state) is None
    got_state, got = local_ba.local_bundle_adjustment(cfg, state, kf)
    assert local_ba._INLINE_GRAPHS == graphs and build.LAUNCHES == launches

    opt_ids, opt_mask, opt_pose, pt_ids, pt_used, pts, stats = (
        local_ba._solve_local_ba(cfg, state, kf))
    kf_pose, pt_xyz = state.kf_pose.clone(), state.pt_xyz.clone()
    kf_pose[opt_ids[opt_mask].long()] = opt_pose[opt_mask]
    pt_xyz[pt_ids[pt_used]] = pts[pt_used]
    assert int(opt_mask.sum()) > 1 and int(pt_used.sum()) > 100
    assert torch.equal(got_state.kf_pose, kf_pose)
    assert torch.equal(got_state.pt_xyz, pt_xyz)
    for a, b in zip(got, stats):
        assert torch.equal(a, b)
    for name in map_state.MapState._fields:
        if name not in ("kf_pose", "pt_xyz"):
            assert getattr(got_state, name) is getattr(state, name), name


@pytest.mark.parametrize("solve, fields", [
    ("inline_local_ba", "SOLVE_FIELDS"),
    ("deferred_local_ba", "DEFERRED_FIELDS"),
])
def test_solve_reads_only_the_fields_its_graph_copies_in(event, solve, fields):
    """A graph's static map holds only the fields it copies in
    (``solve_inputs``): the solve on it equals the solve on the whole map
    bit for bit, inline and deferred."""
    from boslam_tpu_torch.solvers import local_ba

    cfg, kf = event["cfg_t"], _slot(event["kf_id"])
    state = _port(event["states"][6])
    fn = getattr(local_ba, solve)
    inputs = local_ba.solve_inputs(state, getattr(local_ba, fields))
    assert inputs.pt_desc.numel() == 0 and inputs.kf_pose.numel() > 0
    got, ref = local_ba._clone(fn(cfg, inputs, kf)), fn(cfg, state, kf)
    flat = [(a, b) for a, b in zip(got, ref) if isinstance(a, torch.Tensor)]
    flat += list(zip(got[-1], ref[-1]))
    assert len(flat) == len(ref) - 1 + 4
    for a, b in flat:
        assert torch.equal(a, b)
