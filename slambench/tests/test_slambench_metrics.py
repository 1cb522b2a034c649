"""The metric arithmetic on made-up timings and traces."""

import numpy as np
import pytest

import core
import frames
import profiling


class FakeSync:
    count = 0


class FakeEngine:
    """Drains one record per fed frame and counts two host reads each."""

    def __init__(self):
        self.metrics, self.sync, self.flushed = [], FakeSync(), 0

    def feed(self, ts, gray, depth):
        self.sync.count += 2
        self.metrics.append({"ts": ts, "lost": False})

    def flush(self):
        self.flushed += 1


def test_replay_restarts_at_the_sequence_end():
    seq = [(float(i), None, None) for i in range(3)]
    stream = frames.Stream(FakeEngine, seq)
    out = [stream.step() for _ in range(7)]
    assert [r[0][1]["ts"] for r in out] == [0, 1, 2, 0, 1, 2, 0]
    assert len(stream.engines) == 3
    assert [e.flushed for e in stream.engines] == [1, 1, 0]
    assert all(r[0][2] == 2 for r in out)


def _frames_run():
    dts = np.array([0.1, 0.2, 0.1, 0.4, 0.1, 0.2, 0.1, 0.3, 0.1, 0.5])
    kf = np.array([0, 1, 0, 1, 0, 1, 0, 1, 0, 1], bool)
    return {"kind": "frames", "n_frames": 10, "frame_s": dts, "keyframe": kf,
            "host_syncs": 33, "slam_cfg": core.load_json(
                "configs", "tum_vga512")["slam"]}


@pytest.mark.parametrize("name,want", [
    ("host_syncs_per_frame", 3.3),
    ("plain_frame_ms_p50", 100.0),
    ("keyframe_frame_ms_p50", 300.0),
    ("device_ops_per_frame", None),
    ("gba_cg_iters_per_lm", None),
])
def test_frame_readers(name, want):
    got = core.metric_module(name).read(_frames_run())
    assert got == pytest.approx(want) if want is not None else got is None


def test_p90_and_rate_over_the_window():
    dts = np.arange(1, 101) / 1000.0
    assert np.percentile(dts, 90) * 1e3 == pytest.approx(90.1)
    # The rate is every frame completed over the whole window.
    assert len(dts) / dts.sum() == pytest.approx(100 / 5.05)


def test_trace_readers_and_rooflines():
    run = _frames_run()
    run["card"] = "NVIDIA H100 80GB HBM3"
    run["profile_frames"] = {
        "n_frames": 4, "n_ops": 400, "busy_s": 0.1, "window_s": 0.8,
        "by_name": {"fast_rank_kernel(FastTable, float, float, float, int)":
                    [4, 4 * 25e-6],
                    "describe_patches_kernel(PatchTable, ...)": [4, 4 * 3.3e-6],
                    "elementwise": [392, 0.09]}}
    assert core.metric_module("device_ops_per_frame").read(run) == 100
    assert core.metric_module("device_idle_share.frame").read(run) == \
        pytest.approx(0.875)
    fast = core.metric_module("roofline.fast_rank").read(run)
    desc = core.metric_module("roofline.describe_patches").read(run)
    assert 13 < fast < 15 and 18 < desc < 21  # the kernels' H100 times, PERF.md
    run["card"] = "some other card"
    assert core.metric_module("roofline.fast_rank").read(run) is None


def test_gba_readers():
    run = {"kind": "gba", "pcg_steps": [30, 32, 34, 30], "lm_iters": 4,
           "profile_solve": {"busy_s": 0.3, "window_s": 0.5}}
    assert core.metric_module("gba_cg_iters_per_lm").read(run) == 31.5
    assert core.metric_module("device_idle_share.gba").read(run) == \
        pytest.approx(0.4)
    assert core.metric_module("host_syncs_per_frame").read(run) is None


def test_summarize_merges_overlaps_and_names_gaps():
    ev = [(0, 10, "a"), (5, 20, "b"), (30, 40, "c"), (100, 110, "a")]
    s = profiling.summarize(ev, wall_s=1e-6)
    assert s["busy_s"] == pytest.approx(40e-9)
    assert s["n_ops"] == 4
    assert s["idle_gaps"][0] == ["c -> a", pytest.approx(60e-9)]
    assert s["idle_gaps"][1] == ["b -> c", pytest.approx(10e-9)]
    assert s["device_ops"][0][0] == "a" and s["by_name"]["a"][0] == 2


def test_judge_fails_missing_and_non_finite_numbers():
    ok, checks = core.judge({"a": 0.5, "b": 1.0}, {"a": 1.0, "b": 1.0})
    assert ok and checks["a"] == {"value": 0.5, "limit": 1.0}
    assert not core.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not core.judge({}, {"a": 1.0})[0]
    assert not core.judge({"a": 2.0}, {"a": 1.0})[0]
