"""``boslam_tpu_torch.utils.timing`` and the bench's CPU path.

* ``device_peaks`` by card name; ``stage_cost`` against counts worked by
  hand on a tiny config; ``step_utilization``'s weighting;
* every function that measures raises without a card, and so does the
  bench without ``--device cpu``;
* a ``--device cpu`` run of the bench's ``main()`` at the smallest size its
  flags allow prints JSON lines with no device metric, and its stage phase
  reads the engine's spans.
"""

import json

import numpy as np
import pytest
import torch

import _torch_parity as tp
from boslam_tpu_torch import bench
from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.utils import timing


@pytest.mark.parametrize("name, peaks", [
    ("NVIDIA H100 80GB HBM3", (67e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (51e12, 2.0e12)),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_device_peaks(name, peaks):
    assert timing.device_peaks(name) == peaks


TINY = SlamConfig.from_dict({
    "camera": dict(width=64, height=64, depth_wire_stride=2),
    "orb": dict(n_features=4, n_levels=2),
    "tracker": dict(ba_rounds=1, ba_iters=2),
    "map": dict(max_keyframes=4, max_points=8),
    "local_ba": dict(n_opt_kf=1, n_fixed_kf=1, max_local_points=2, lm_iters=1),
})


def test_stage_cost_by_hand():
    # feature: two 64x64 levels (the pyramid's floor is 64 px), 4 keypoints.
    ops = 12 * 4096 + (28 + 56) * 8192 + (4 * 32 * 32 + 13 * 256 + 50) * 4
    nbytes = 4 * 64 * 64 + 4 * 32 * 32 + 70 * 4
    assert timing.stage_cost(TINY, "feature") == (ops, nbytes) == (767176, 20760)
    # track: two searches over 8 points x 4 keypoints, 1 round of 2 GN steps.
    per_search = 52 * 8 + 35 * 4 * 8 + 4 * (2 * 300 + 30)
    assert timing.stage_cost(TINY, "track") == (2 * per_search, 70 * 8 + 59 * 4) \
        == (8112, 796)
    # local_ba: 2 cameras (1 optimized) x 2 points, one iteration, a 6x6
    # camera system, two cost evaluations; 4 keyframes' covisibility row.
    per_iter = (247 * 2 * 2 + 378 * 2 + 2 * (81 + 180 + 216) + 6 ** 3 // 3
                + 2 * 36)
    ops = per_iter + 2 * 40 * 4
    nbytes = 2 * (28 + 21 * 4) + 5 * 4 + 25 * 2 + 28
    assert timing.stage_cost(TINY, "local_ba") == (ops, nbytes) == (3162, 322)
    with pytest.raises(ValueError):
        timing.stage_cost(TINY, "loop")


def test_step_utilization_weights_local_ba():
    peaks = (1e12, 2e12)
    got = timing.step_utilization(TINY, 2.0, 0.25, peaks)
    flops = 767176 + 8112 + 0.25 * 3162
    nbytes = 20760 + 796 + 0.25 * 322
    assert got == pytest.approx({"step_gflops": flops / 1e9,
                                 "step_util_flops": flops / 2e-3 / 1e12,
                                 "step_bytes_gbps": nbytes / 2e-3 / 1e9})
    assert timing.step_utilization(TINY, 2.0, 0.25, None) == {}


@pytest.fixture(scope="module")
def engine():
    from boslam_tpu_torch.slam import SlamSystem

    _, cfg_t = tp.configs(tp.SMALL)
    _, frames = tp.orbit_frames(cfg_t.camera, 8, depth_noise=0.01, seed=2)
    slam = SlamSystem(cfg_t, device="cpu")
    for f in frames[:7]:
        slam.feed(*f)
    slam.flush()
    return slam, frames


def test_timing_raises_without_card(engine, monkeypatch):
    slam, frames = engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: timing.frame_device_ms(slam, frames[7:]),
                 timing.device_peaks, timing.card,
                 lambda: bench.main(["--frames", "2"])):
        with pytest.raises(RuntimeError):
            call()
    assert slam.metrics and len(slam.metrics) == 7


def _device_keys(line):
    return sorted(k for k in line
                  if k.startswith(("device_", "step_", "card", "power_"))
                  or "_util_" in k or k.endswith("_launches_per_frame")
                  or "_device" in k or k == "stages_idle_ms"
                  or k == "warmup_build_s")


def test_main_on_cpu_writes_no_device_metric(capsys):
    bench.main(["--device", "cpu", "--frames", "3", "--warmup-frames", "1",
                "--no-global-ba", "--no-tracked-ba"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 2
    primary, final = lines
    for line in lines:
        assert line["device"] == "cpu"
        assert _device_keys(line) == []
        assert np.isfinite(line["fps"]) and np.isfinite(line["ate_rmse_m"])
    assert all(final[k] == v for k, v in primary.items())
    assert {"ate_loop_off_m", "ate_noise0_m", "loops_noise0", "phase_times",
            "phases_skipped", "elapsed_s"} <= final.keys()
    assert "device_path" in final["phases_skipped"]
    assert "stages" not in final["phases_skipped"]
    stages = final["stages_host_ms"]
    assert {"frame", "frame.upload", "frame.frontend", "frame.track",
            "sync.read", "flush", "flush.readback"} <= stages.keys()
    assert all(v > 0 for v in stages.values())
    assert final["stages_per_frame"]["frame.frontend"] == 1.0
