"""Relocalization's spans and the engine's relocalization counters on a
small CPU kidnap (the orbit of ``tests/test_torch_slam.py``'s kidnap test).

Frame 10 is blank before a flush has trained the vocabulary, so frame 11
relocalizes through the whole map; frame 33 is blank after the second
flush trained it, so frame 34 relocalizes through the BoW candidates.
"""

import numpy as np
import pytest

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.io import synthetic
from boslam_tpu_torch.slam import SlamSystem

BLANK = (10, 33)
CFG = {"camera": dict(width=320, height=240, fx=130.0, fy=130.0, cx=160.0,
                      cy=120.0),
       "orb": dict(n_features=256, n_levels=4),
       "loop": dict(min_gap_kf=6, consistency=2)}


@pytest.fixture(scope="module")
def runs():
    cfg = SlamConfig.from_dict(CFG)
    traj = synthetic.orbit_trajectory(40, radius=0.5, yaw_amplitude=0.2)
    frames = list(synthetic.render_sequence(cfg.camera, traj))
    for i in BLANK:
        ts, rgb, depth = frames[i]
        frames[i] = (ts, np.zeros_like(rgb), np.zeros_like(depth))
    out = []
    for trace in (False, True):
        slam = SlamSystem(cfg, device="cpu", chunk=1, trace=trace)
        for f in frames:
            slam.feed(*f)
        slam.flush()
        out.append(slam)
    return out


def _relocs(slam):
    return [(i, m["reloc_ok"], m["reloc_whole_map"])
            for i, m in enumerate(slam.metrics) if m.get("event") == "relocalize"]


def test_counters_count_tries_successes_and_the_whole_map_path(runs):
    off, on = runs
    assert _relocs(off) == [(11, True, True), (34, True, False)]
    for slam in runs:
        assert (slam.n_reloc_tries, slam.n_reloc_ok, slam.n_reloc_whole_map) \
            == (2, 2, 1)


def test_counters_add_no_host_read(runs):
    off, on = runs
    assert off.sync.count == on.sync.count
    assert _relocs(off) == _relocs(on)
    assert np.array_equal(np.stack(off.poses_twc), np.stack(on.poses_twc))


def test_relocalize_spans_nest_under_the_frame(runs):
    _, on = runs
    spans = {s.id: s for s in on.sync.spans}
    reloc = [s for s in spans.values() if s.name == "frame.relocalize"]
    assert sorted(s.request for s in reloc) == [11, 34]
    for outer in reloc:
        inner = sorted((s for s in spans.values() if s.parent == outer.id),
                       key=lambda s: s.t0)
        assert [s.name for s in inner] == ["reloc.candidates", "reloc.solve"]
        assert all(outer.t0 <= s.t0 <= s.t1 <= outer.t1 for s in inner)
        # The branch's one host read (the vocabulary flag) is a candidate's.
        reads = [s for s in spans.values()
                 if s.name == "sync.read" and s.parent == inner[0].id]
        assert len(reads) == 1
        assert not any(s.parent == inner[1].id for s in spans.values())
