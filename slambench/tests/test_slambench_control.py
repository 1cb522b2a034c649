"""The controls on the card at a size a test run holds: the reference
computed with TF32 on, in the program's place, has to fail the cell's
limits; and ``hall.loop`` at its own size, sound and with its loop
correction handing back the map unchanged.  Each test decides inside
itself whether there is a card."""

import json

import numpy as np
import pytest
import torch

import core
import gba
import problem
import render
import run
from frames import kp_mismatch
from reference.frontend import Frontend


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return torch.device("cuda")


@pytest.fixture
def tf32_off():
    yield
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["hall.live", "survey.track"])
def test_frontend_in_tf32_fails_the_keypoint_limit(cell, tf32_off):
    dev = _card()
    spec = core.cell(cell)
    slam_cfg, tr = spec["config_spec"]["slam"], spec["traffic_spec"]
    traj = render.trajectory(tr["path"])
    traj = render.Trajectory(traj.poses_twc[:60:15], traj.timestamps[:60:15])
    frames = render.render_wire(render.Camera.from_config(slam_cfg), traj,
                                depth_noise=tr["depth_noise"],
                                room_scale=tr["room_scale"],
                                generator=torch.Generator(dev).manual_seed(3),
                                device=dev)
    fe = Frontend(slam_cfg, dev)
    miss = total = 0
    for _, gray, d16 in frames:
        g = torch.from_numpy(gray).to(dev)
        d = torch.from_numpy(d16.astype(np.int32)).to(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = fe(g, d)
        row = {"kf_uv": ref.uv.cpu(), "kf_desc": ref.desc.cpu(),
               "kf_octave": ref.octave.cpu(), "kf_kp_valid": ref.valid.cpu(),
               "kf_depth": ref.depth.cpu()}
        assert kp_mismatch(row, ref) == (0, int(ref.valid.sum()))
        torch.backends.cuda.matmul.allow_tf32 = True
        m, t = kp_mismatch(row, fe(g, d))
        miss, total = miss + m, total + t
    assert miss / total > spec["limits"]["kp_mismatch"]


@pytest.mark.cuda
def test_global_ba_reference_in_tf32_fails_the_cost_limits():
    dev = _card()
    spec = core.cell("survey.gba50k")
    slam_cfg, tr = spec["config_spec"]["slam"], spec["traffic_spec"]
    raw = problem.make(dict(tr, **tr["rehearsal"]), slam_cfg, 11)
    _, _, c0_ref, _ = gba._reference_solve(slam_cfg, raw, 1, torch.float64, dev)
    _, _, c0, _ = gba._reference_solve(slam_cfg, raw, 1, torch.float32, dev,
                                       tf32=True)
    gap = abs(float(c0) - float(c0_ref)) / float(c0_ref)
    assert gap > spec["limits"]["cost0_rel_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "loop_unchanged"])
def test_loop_cell_on_the_card(capsys, monkeypatch, fault):
    """30 s: an engine feeds all 320 frames and closes its loop."""
    _card()
    from test_slambench_faults import LOOP_FAULTS

    if fault is not None:
        LOOP_FAULTS[fault](monkeypatch, fault)
    assert run.main(["--workload", "hall.loop", "--seed", str(2**31 + 101),
                     "--seconds", "30"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is (fault is None), line["checks"]
    assert line["checks"]["loop_closures_missing"]["value"] == 0
