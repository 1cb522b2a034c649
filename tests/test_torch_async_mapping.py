"""Asynchronous local mapping in the port against the JAX package:
``deferred_local_ba`` / ``merge_local_ba`` on a JAX map carried over by
``convert``, the merge guards, the wholesale drop after a loop closure, and
the whole async engine against the JAX async engine (SMALL config, 32
frames, ``chunk=8``).

Tolerances: integer and bool fields exact; poses within atol 1e-4 and
costs within rtol 1e-4, as tests/test_torch_mapping.py holds local BA;
the whole run as tests/test_torch_slam.py holds a run (anchored poses within
1 cm, ATE within 10% + 1 mm)."""

import numpy as np
import pytest
import torch

import _torch_parity as tp
from boslam_tpu_torch import convert
from boslam_tpu_torch.geometry import align
from boslam_tpu_torch.mapping.map_state import latest_kf_slot
from boslam_tpu_torch.slam import SlamSystem, run_sequence
from boslam_tpu_torch.solvers.local_ba import deferred_local_ba, merge_local_ba

BA_POSE_ATOL, BA_COST_RTOL = 1e-4, 1e-4
POSE_ATOL_M = 0.01
ATE_RTOL, ATE_ATOL_M = 0.10, 0.001
N_FRAMES, CHUNK = 32, 8


def _events(slam):
    return [(i, m.get("event"), m["status"], m.get("kf_id"), m.get("ba_edges"),
             bool(m.get("ba_dropped"))) for i, m in enumerate(slam.metrics)]


def _ate(est, gt):
    rmse, _ = align.ate_rmse(torch.from_numpy(np.asarray(est[:, 4:], np.float32)),
                             torch.from_numpy(np.asarray(gt[:, 4:], np.float32)))
    return float(rmse)


@pytest.fixture(scope="module")
def runs():
    """The JAX async engine and the port's, on the same frames."""
    from boslam_tpu.slam import SlamSystem as JaxSlam

    cfg_j, cfg_t = tp.configs(tp.SMALL)
    traj, frames = tp.orbit_frames(cfg_t.camera, N_FRAMES)
    ref = JaxSlam(cfg_j, chunk=CHUNK, async_mapping=True)
    ref.MAX_VERIFY = 0
    for f in frames:
        ref.feed(*f)
    ref.flush()
    got = SlamSystem(cfg_t, chunk=CHUNK, device="cpu", async_mapping=True)
    got.MAX_VERIFY = 0
    for f in frames:
        got.feed(*f)
    got.flush()
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, traj=traj, frames=frames, ref=ref,
                got=got)


def test_async_engine_matches_jax_async_engine(runs):
    ref, got = runs["ref"], runs["got"]
    assert _events(got) == _events(ref)
    assert sum(m.get("event") == "keyframe" for m in got.metrics) >= 5
    _, est_ref = ref.trajectory()
    _, est = got.trajectory()
    assert est.shape == (N_FRAMES, 7) and np.all(np.isfinite(est))
    np.testing.assert_array_less(
        np.linalg.norm(est[:, 4:] - est_ref[:, 4:], axis=1), POSE_ATOL_M)
    gt = runs["traj"].poses_twc
    ate_ref, ate = _ate(est_ref, gt), _ate(est, gt)
    assert abs(ate - ate_ref) <= ATE_RTOL * ate_ref + ATE_ATOL_M, (ate, ate_ref)
    # Every landed solve's stats reached its keyframe's record.
    landed = [(m, r) for m, r in zip(got.metrics, ref.metrics)
              if m.get("event") == "keyframe"]
    for m, r in landed:
        np.testing.assert_allclose([m["ba_cost0"], m["ba_cost1"]],
                                   [r["ba_cost0"], r["ba_cost1"]],
                                   rtol=BA_COST_RTOL)
    assert all(m["ba_cost1"] <= m["ba_cost0"] and m["ba_edges"] > 0
               for m, _ in landed)
    assert got.n_keyframes == ref.n_keyframes
    assert got.n_points == ref.n_points


def test_mapping_device_cpu_is_the_async_path(runs):
    """On a CPU engine ``mapping_device="cpu"`` is the same-device path:
    the run equals ``async_mapping=True`` exactly."""
    cfg_t, frames = runs["cfg_t"], runs["frames"]
    same = SlamSystem(cfg_t, chunk=CHUNK, device="cpu", mapping_device="cpu")
    assert same.async_mapping and same._mapping_stream is None
    same.MAX_VERIFY = 0
    for f in frames:
        same.feed(*f)
    same.flush()
    got = runs["got"]
    _, est = got.trajectory()
    _, est_same = same.trajectory()

    def no_clock(metrics):
        return [{k: v for k, v in m.items() if k != "dt_ms"} for m in metrics]

    assert no_clock(same.metrics) == no_clock(got.metrics)
    np.testing.assert_array_equal(est_same, est)
    for k in ("kf_pose", "pt_xyz", "kf_seq", "pt_valid"):
        assert torch.equal(getattr(same.map, k), getattr(got.map, k)), k


def _jax_map_and_center(runs):
    """The JAX async engine's final map (its solves landed) and its latest
    keyframe slot."""
    from boslam_tpu.mapping.map_state import latest_kf_slot as j_latest

    ref = runs["ref"]
    ref.trajectory()
    return ref.map, j_latest(ref.map)


def test_deferred_and_merge_match_jax(runs):
    """``deferred_local_ba`` and ``merge_local_ba`` on the same JAX map:
    ids, masks and guards exact, poses and points within 1e-4, costs within
    rtol 1e-4; the merge into a map whose slots moved on, field by field."""
    from boslam_tpu.solvers import local_ba as j_lba

    cfg_j, cfg_t = runs["cfg_j"], runs["cfg_t"]
    ms_j, center = _jax_map_and_center(runs)
    ref = j_lba.deferred_local_ba(cfg_j, ms_j, center)
    ms_t = tp.port_state(ms_j, convert.map_state_from_numpy)
    got = deferred_local_ba(cfg_t, ms_t, torch.tensor(int(center), dtype=torch.int32))
    for k in ("opt_ids", "opt_mask", "opt_seq", "pt_ids", "pt_used", "pt_gen"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    assert int(np.asarray(ref.opt_mask).sum()) >= 3
    np.testing.assert_allclose(got.opt_pose.numpy(), np.asarray(ref.opt_pose),
                               atol=BA_POSE_ATOL)
    np.testing.assert_allclose(got.pt_xyz.numpy(), np.asarray(ref.pt_xyz),
                               atol=BA_POSE_ATOL)
    for k in ("cost0", "cost1"):
        np.testing.assert_allclose(float(getattr(got.stats, k)),
                                   float(getattr(ref.stats, k)), rtol=BA_COST_RTOL)
    for k in ("n_edges", "n_points"):
        assert int(getattr(got.stats, k)) == int(getattr(ref.stats, k)), k

    # A map that moved on: one optimized slot reused, one point reused, one
    # keyframe culled.
    opt = np.asarray(ref.opt_ids)[np.asarray(ref.opt_mask)]
    pts = np.asarray(ref.pt_ids)[np.asarray(ref.pt_used)]
    moved = ms_j._replace(
        kf_seq=ms_j.kf_seq.at[int(opt[1])].add(7),
        kf_valid=ms_j.kf_valid.at[int(opt[2])].set(False),
        pt_first_kf=ms_j.pt_first_kf.at[int(pts[0])].add(7),
    )
    want = j_lba.merge_local_ba(cfg_j, moved, ref)
    have = merge_local_ba(cfg_t, tp.port_state(moved, convert.map_state_from_numpy),
                          got)
    tp.assert_state_close(want, have, atol=BA_POSE_ATOL)


def test_merge_guards_protect_reused_slots(runs):
    """A deferred result whose targets were culled or reused since the
    snapshot leaves the slots' new tenants as they are; untouched entries
    still receive the solve (tests/test_async_mapping.py:59)."""
    got = runs["got"]
    got.trajectory()
    st = got.map
    res = deferred_local_ba(runs["cfg_t"], st, latest_kf_slot(st))
    kf_slot = int(res.opt_ids[int(torch.argmax(res.opt_mask.to(torch.int32)))])
    pt_slot = int(res.pt_ids[int(torch.argmax(res.pt_used.to(torch.int32)))])
    kf_seq, pt_first = st.kf_seq.clone(), st.pt_first_kf.clone()
    kf_seq[kf_slot] += 7
    pt_first[pt_slot] += 7
    st2 = st._replace(kf_seq=kf_seq, pt_first_kf=pt_first)
    merged = merge_local_ba(runs["cfg_t"], st2, res)
    assert torch.equal(merged.kf_pose[kf_slot], st2.kf_pose[kf_slot])
    assert torch.equal(merged.pt_xyz[pt_slot], st2.pt_xyz[pt_slot])
    merged_ok = merge_local_ba(runs["cfg_t"], st, res)
    assert not torch.equal(merged_ok.kf_pose, st.kf_pose) or \
        not torch.equal(merged_ok.pt_xyz, st.pt_xyz)
    # Only the guarded entries differ between the two merges.
    diff_kf = torch.nonzero((merged.kf_pose != merged_ok.kf_pose).any(-1)).flatten()
    diff_pt = torch.nonzero((merged.pt_xyz != merged_ok.pt_xyz).any(-1)).flatten()
    assert set(diff_kf.tolist()) <= {kf_slot}
    assert set(diff_pt.tolist()) <= {pt_slot}


def test_pending_dropped_after_loop_closure(runs):
    """A loop closure between dispatch and merge moved the whole
    trajectory: the pending solves are dropped wholesale, flagged on their
    keyframes' records, and the map is left as it was
    (tests/test_async_mapping.py:94)."""
    slam = SlamSystem(runs["cfg_t"], chunk=CHUNK, device="cpu",
                      async_mapping=True)
    slam.MAX_VERIFY = 0
    for f in runs["frames"][:2 * CHUNK]:
        slam.feed(*f)
    assert slam._pending_ba is not None
    recs = [rec for _, _, rec in slam._pending_ba.solves]
    assert recs and all(r["ba_cost0"] == 0.0 for r in recs)
    before = slam.map.kf_pose.clone()
    slam.n_loops_closed += 1  # a closure since the dispatch
    slam._merge_pending_ba()
    assert slam._pending_ba is None
    assert torch.equal(slam.map.kf_pose, before)
    assert all(r.get("ba_dropped") for r in recs)


def test_async_entry_points_need_a_card(monkeypatch):
    """Async mode keeps the device rule: no card, no default engine; a
    mapping device that names a CUDA card raises without one, also on a
    CPU engine."""
    cfg = tp.configs(tp.SMALL)[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamSystem(cfg, async_mapping=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sequence(cfg, [], async_mapping=True)
    for md in (0, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            SlamSystem(cfg, device="cpu", mapping_device=md)
