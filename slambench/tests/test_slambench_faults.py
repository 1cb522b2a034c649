"""A whole run of each cell at its rehearsal size on the CPU (the look for
a card skipped), with the timed path broken underneath: ``correct`` has to
come out false for each fault the cell can have, and true without one.
The cells run on one card, so the fault of an exchange between chips
left out does not arise.  A rehearsal's window also runs until the mix's
``rehearsal.frames`` are done, so that a local-BA solve (and in
``hall.loop`` a loop closure) falls inside it however loaded the machine."""

import json

import pytest
import torch

import run

OFFSET = 2.0  # metres added to every other pose
SECONDS = {"hall.live": 5, "survey.track": 18, "survey.gba50k": 2,
           "hall.loop": 1}


def _line(capsys, cell, seed=2**31 + 17):
    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     str(SECONDS[cell]), "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _frame_step(monkeypatch, fault):
    import boslam_tpu_torch.slam as slam

    orig, n = slam.frame_step_core, [0]

    def broken(cfg, map_state, loop_state, track, *args, **kw):
        out = orig(cfg, map_state, loop_state, track, *args, **kw)
        n[0] += 1
        if fault == "unchanged":
            return map_state, loop_state, track, out[3]
        if n[0] % 2:  # the pose and the pose relative to its keyframe
            out[3][slam.O_POSE0 + 4] += OFFSET
            out[3][slam.O_REL0 + 4] += OFFSET
        return out

    monkeypatch.setattr(slam, "frame_step_core", broken)


def _features(monkeypatch, fault):
    import boslam_tpu_torch.slam as slam

    orig = slam.extract_features

    def broken(gray, depth, cfg):
        f = orig(gray, depth, cfg)
        if fault == "half":
            valid = f.valid.clone()
            valid[1::2] = False
            return f._replace(valid=valid, has_depth=f.has_depth & valid)
        return f._replace(desc=f.desc ^ 1)

    monkeypatch.setattr(slam, "extract_features", broken)


def _local_ba(monkeypatch, fault):
    import boslam_tpu_torch.slam as slam

    orig = slam.local_bundle_adjustment

    def broken(cfg, state, center):
        if fault == "lba_half":  # half the keypoints' edges left out
            kpv = state.kf_kp_valid.clone()
            kpv[:, 1::2] = False
            out, stats = orig(cfg, state._replace(kf_kp_valid=kpv), center)
            return out._replace(kf_kp_valid=state.kf_kp_valid), stats
        _, stats = orig(cfg, state, center)
        if fault == "lba_unchanged_cost":  # and reports no change
            stats = stats._replace(cost1=stats.cost0)
        return state, stats

    monkeypatch.setattr(slam, "local_bundle_adjustment", broken)


def _global_ba(monkeypatch, fault):
    import boslam_tpu_torch.solvers.global_ba as gba

    orig = gba.global_bundle_adjustment

    def broken(cfg, state, **kw):
        if fault == "half":
            kpv = state.kf_kp_valid.clone()
            kpv[:, 1::2] = False
            out, stats = orig(cfg, state._replace(kf_kp_valid=kpv), **kw)
            return out._replace(kf_kp_valid=state.kf_kp_valid), stats
        out, stats = orig(cfg, state, **kw)
        if fault == "unchanged":
            return state, stats._replace(cost1=stats.cost0)
        xyz = out.pt_xyz.clone()
        xyz[:200] += 0.5
        return out._replace(pt_xyz=xyz), stats

    monkeypatch.setattr(gba, "global_bundle_adjustment", broken)


def _loop(monkeypatch, fault):
    import boslam_tpu_torch.slam as slam
    import boslam_tpu_torch.solvers.pose_graph as pg

    if fault == "loop_unchanged":  # the correction hands back its map
        orig = slam.close_loop_update

        def broken(cfg, state, kf_id, *args):
            orig(cfg, state, kf_id, *args)
            return state, state.kf_pose[kf_id.long()]

        monkeypatch.setattr(slam, "close_loop_update", broken)
        return
    orig = pg.build_essential_edges

    def thinned(cfg, state, *args, **kw):  # every other edge left out
        edges = orig(cfg, state, *args, **kw)
        valid = edges.valid.clone()
        valid[1::2] = False
        return edges._replace(valid=valid)

    monkeypatch.setattr(pg, "build_essential_edges", thinned)


LOOP_FAULTS = {"loop_unchanged": _loop, "graph_half": _loop}

FRAME_FAULTS = {
    "unchanged": _frame_step,   # a step that returns its state unchanged
    "half": _features,          # half of the keypoints left out
    "pose": _frame_step,        # an answer altered: every other pose
    "descriptor": _features,    # an answer altered: the descriptors
    "lba_unchanged": _local_ba,  # local BA returns its window unchanged
    "lba_unchanged_cost": _local_ba,
    "lba_half": _local_ba,
}


@pytest.mark.parametrize("cell", ["hall.live", "survey.track", "hall.loop"])
def test_frame_cell_sound_run_is_correct(capsys, cell):
    line = _line(capsys, cell)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", sorted(FRAME_FAULTS))
def test_frame_cell_fault_is_caught(capsys, monkeypatch, fault):
    FRAME_FAULTS[fault](monkeypatch, fault)
    line = _line(capsys, "hall.live")
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", sorted(LOOP_FAULTS))
def test_loop_cell_fault_is_caught(capsys, monkeypatch, fault):
    LOOP_FAULTS[fault](monkeypatch, fault)
    line = _line(capsys, "hall.loop")
    assert not line["correct"], line["checks"]
    assert line["checks"]["pg_cost_rel_gap"]["value"] > \
        line["checks"]["pg_cost_rel_gap"]["limit"]


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_gba_cell(capsys, monkeypatch, fault):
    if fault is not None:
        _global_ba(monkeypatch, fault)
    line = _line(capsys, "survey.gba50k")
    assert line["correct"] is (fault is None), line["checks"]
    torch.backends.cuda.matmul.allow_tf32 = False
