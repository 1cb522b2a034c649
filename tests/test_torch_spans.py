"""The engine's spans (``tracking.tracker.HostSync``) and their attribution
to the device trace (``utils.timing``) on the CPU.

* off, ``span`` is the one shared no-op context and no clock is read;
* on, the engine computes bit for bit what it computes off, with the same
  host reads, and a frame's spans nest as the frame step runs;
* a global-BA solve opens one ``gba.cg_apply`` span per CG iteration;
* the attribution, on made-up spans and events: an operation goes to the
  span open at its launch, an idle stretch to the innermost span open on
  the host meanwhile; the clock's mapping and its check by the reads;
* the spans as Chrome trace events on the profiler trace's clock.
"""

import json
import time

import numpy as np
import pytest
import torch

import _torch_parity as tp
from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.io import synthetic
from boslam_tpu_torch.slam import SlamSystem
from boslam_tpu_torch.solvers.global_ba import global_bundle_adjustment
from boslam_tpu_torch.tracking import tracker
from boslam_tpu_torch.tracking.tracker import HostSync, Span
from boslam_tpu_torch.utils import timing

N_FRAMES = 30


@pytest.fixture(scope="module")
def clover():
    """The bench's 3-petal clover at the parity tests' small size."""
    _, cfg = tp.configs(tp.SMALL)
    traj = synthetic.clover_trajectory(N_FRAMES, n_petals=3, radius=0.6,
                                       yaw_amplitude=0.3)
    return cfg, synthetic.render_sequence(cfg.camera, traj, depth_noise=0.01,
                                          seed=4)


def _run(cfg, frames, trace):
    slam = SlamSystem(cfg, device="cpu", chunk=1, trace=trace)
    for f in frames:
        slam.feed(*f)
    slam.flush()
    return slam


@pytest.fixture(scope="module")
def runs(clover):
    cfg, frames = clover
    return _run(cfg, frames, False), _run(cfg, frames, True)


def test_recorder_off_reads_no_clock(clover, monkeypatch):
    cfg, frames = clover
    slam = SlamSystem(cfg, device="cpu", chunk=1)
    assert slam.sync.span("frame") is tracker._NO_SPAN
    assert slam.sync.span("flush", 3) is slam.sync.span("frame.track")

    def no_clock():
        raise AssertionError("a span read the clock while tracing is off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    for f in frames[:10]:
        slam.feed(*f)
    slam.flush()
    assert len(slam.metrics) == 10 and slam.sync.drain() == []


def test_tracing_leaves_poses_and_reads_unchanged(runs):
    off, on = runs
    assert np.array_equal(np.stack(off.poses_twc), np.stack(on.poses_twc))
    for a, b in zip(off.map, on.map):
        assert torch.equal(a, b)
    assert off.sync.count == on.sync.count > N_FRAMES
    reads = [s for s in on.sync.spans if s.name == "sync.read"]
    assert len(reads) == on.sync.count
    assert sum(r.get("event") == "keyframe" for r in on.metrics) >= 2


def test_keyframe_frame_nests_its_stages(runs):
    _, on = runs
    spans = on.sync.spans
    by_id = {s.id: s for s in spans}
    frames = [s for s in spans if s.name == "frame"]
    assert [s.request for s in frames] == list(range(N_FRAMES))
    assert all(s.parent == -1 for s in frames)
    kf = next(i for i, r in enumerate(on.metrics)
              if r.get("event") == "keyframe")
    root = frames[kf]

    def children(parent):
        return [s.name for s in spans if s.parent == parent.id]

    assert [n for n in children(root) if n != "sync.read"] == [
        "frame.upload", "frame.frontend", "frame.track", "frame.keyframe",
        "flush"]
    event = next(s for s in spans
                 if s.parent == root.id and s.name == "frame.keyframe")
    assert [n for n in children(event) if n != "sync.read"] == [
        "keyframe.map", "keyframe.local_ba", "keyframe.cull_kf",
        "keyframe.bow_loop"]
    flush = next(s for s in spans if s.parent == root.id and s.name == "flush")
    assert children(flush) == ["flush.readback"]
    for s in spans:
        if s.request == kf and s.parent >= 0:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1 and p.request == kf
    # A plain frame tracks and opens no keyframe event.
    plain = next(i for i, r in enumerate(on.metrics)
                 if i > 0 and "event" not in r)
    assert "frame.keyframe" not in children(frames[plain])
    assert "frame.track" in children(frames[plain])


def test_drain_hands_over_closed_spans_only():
    sync = HostSync(trace=True)
    with sync.span("frame", 7):
        with sync.span("frame.frontend"):
            pass
        (inner,) = sync.drain()
    (outer,) = sync.drain()
    assert (inner.name, inner.parent, inner.request) == (
        "frame.frontend", outer.id, 7)
    assert (outer.name, outer.parent, outer.request) == ("frame", -1, 7)
    with sync.span("gba.solve"):
        with sync.span("gba.cg"):
            pass
    cg, root = sync.drain()
    assert (cg.parent, cg.request) == (root.id, root.id) and root.parent == -1


def test_cg_apply_spans_match_pcg_steps():
    cfg = SlamConfig.from_dict(dict(map=dict(max_keyframes=12,
                                             max_points=4096),
                                    orb=dict(n_features=128)))
    st, _, _ = synthetic.synthetic_ba_problem(
        cfg, np.random.default_rng(5), n_kf=12, n_pts=600, obs_per_kf=96)
    sync = HostSync(trace=True)
    _, stats = global_bundle_adjustment(cfg, st, lm_iters=3, cg_iters=20,
                                        sync=sync)
    spans = sync.drain()
    names = [s.name for s in spans]
    assert names.count("gba.cg_apply") == sum(stats.pcg_steps) > 3
    assert names.count("gba.assemble") == names.count("gba.cg") == 3
    assert names.count("sync.read") == sync.count
    (root,) = [s for s in spans if s.name == "gba.solve"]
    assert all(s.request == root.id for s in spans)
    cg = {s.id for s in spans if s.name == "gba.cg"}
    assert all(s.parent in cg for s in spans if s.name == "gba.cg_apply")


def _span(i, name, t0, t1, parent=-1):
    return Span(i, name, parent, t0, t1, 0)


# Host spans (ns): a frame 0-100 holding the frontend 10-40 and tracking
# 50-90, which holds a read 70-80.
SPANS = [_span(1, "frame.frontend", 10, 40, 0),
         _span(3, "sync.read", 70, 80, 2),
         _span(2, "frame.track", 50, 90, 0),
         _span(0, "frame", 0, 100)]


def test_innermost_stretches():
    got = timing._innermost([(s.t0, s.t1, s.name) for s in SPANS])
    assert got == [(0, 10, "frame"), (10, 40, "frame.frontend"),
                   (40, 50, "frame"), (50, 70, "frame.track"),
                   (70, 80, "sync.read"), (80, 90, "frame.track"),
                   (90, 100, "frame")]


@pytest.mark.parametrize("shift", [0, 1_000_000])
def test_operations_go_to_the_span_open_at_their_launch(shift):
    # Runtime calls and device operations on the profiler's clock, which
    # runs ``shift`` ahead of the spans'.
    calls = [(15 + shift, 16 + shift, "cudaLaunchKernel", 1),
             (38 + shift, 39 + shift, "cudaLaunchKernel", 2),
             (72 + shift, 79 + shift, "cudaMemcpyAsync", 3),
             (95 + shift, 96 + shift, "cudaLaunchKernel", 4),
             (120 + shift, 121 + shift, "cudaLaunchKernel", 5)]
    ops = [(20 + shift, 30 + shift, "fast_rank", 1),
           (45 + shift, 60 + shift, "describe", 2),   # ran after its span
           (75 + shift, 77 + shift, "memcpy", 3),
           (97 + shift, 99 + shift, "pack", 4),
           (122 + shift, 123 + shift, "late", 5),
           (124 + shift, 125 + shift, "orphan", 9)]
    got = timing.attribute(SPANS, lambda t: t + shift, ops, calls)
    assert got["ops_by_span"] == {
        "frame.frontend": [2, pytest.approx(25e-9)],
        "sync.read": [1, pytest.approx(2e-9)],
        "frame": [1, pytest.approx(2e-9)],
        timing.NO_SPAN: [1, pytest.approx(1e-9)],
        "no launch record": [1, pytest.approx(1e-9)]}
    # Busy 20-30, 45-60, 75-77, 97-99, 122-123, 124-125 of the window
    # 20-125; idle 30-45 (the frontend to 40, then the frame), 60-75
    # (tracking to 70, then the read), 77-97 (the read to 80, tracking to
    # 90, then the frame), 99-122 (the frame to 100, then no span) and
    # 123-124 (no span).
    idle = {k: round(v * 1e9) for k, v in got["idle_by_span"].items()}
    assert idle == {"frame.frontend": 10, "frame": 5 + 7 + 1,
                    "frame.track": 10 + 10, "sync.read": 5 + 3,
                    timing.NO_SPAN: 22 + 1}
    assert got["busy_s"] * 1e9 == pytest.approx(10 + 15 + 2 + 2 + 1 + 1)
    assert got["window_s"] * 1e9 == pytest.approx(105)
    assert sum(idle.values()) + 31 == 105


def test_idle_before_and_after_the_operations_counts_in_the_window():
    ops = [(30, 40, "k", 1)]
    calls = [(12, 13, "cudaLaunchKernel", 1)]
    got = timing.attribute(SPANS, lambda t: t, ops, calls, window=(0, 110))
    idle = {k: round(v * 1e9) for k, v in got["idle_by_span"].items()}
    assert idle == {"frame": 10 + 10 + 10, "frame.frontend": 20,
                    "frame.track": 30, "sync.read": 10, timing.NO_SPAN: 10}
    assert got["ops_by_span"] == {"frame.frontend": [1, pytest.approx(1e-8)]}


def test_clock_map_and_its_check_by_the_reads():
    before, after = (1_000, 5_000_000_000), (2_001_000, 5_002_000_020)
    to_clock = timing.clock_map(before, after)
    assert to_clock(1_000) == 5_000_000_000
    assert to_clock(2_001_000) == 5_002_000_020
    assert to_clock(1_001_000) == 5_001_000_010
    spans = [Span(0, "sync.read", -1, 1_000, 1_100, 0),
             Span(1, "sync.read", -1, 2_000, 2_050, 1),
             Span(2, "frame", -1, 0, 3_000, 2),
             Span(3, "sync.read", -1, 2_500, 2_510, 2)]
    u = 5_000_000_000 - 1_000
    calls = [(u + 1_010, u + 1_020, "cudaMemcpyAsync", 1),
             (u + 1_030, u + 1_090, "cudaStreamSynchronize", 2),
             (u + 2_020, u + 2_045, "cudaMemcpyAsync", 3)]
    got = timing.clock_slack(spans, lambda t: t + u, calls)
    assert got == {"reads": 3, "empty": 1, "before_ns": 10, "after_ns": 5}


def test_chrome_events_on_the_trace_clock(tmp_path):
    trace = tmp_path / "host.123.pt.trace.json"
    trace.write_text('{\n "schemaVersion": 1,\n "baseTimeNanoseconds": '
                     '1700000000000000000,\n "traceEvents": []}')
    base = timing.trace_base_ns(str(trace))
    assert base == 1_700_000_000_000_000_000
    events = timing.chrome_events(SPANS, lambda t: t + base + 2_000, base)
    assert [e["name"] for e in events] == [
        "frame", "frame.frontend", "frame.track", "sync.read"]
    assert events[2]["ts"] == pytest.approx(2.05)
    assert events[2]["dur"] == pytest.approx(0.04)
    json.dumps(events)
    (tmp_path / "empty.json").write_text("{}")
    assert timing.trace_base_ns(str(tmp_path / "empty.json")) == 0
