"""The port's CLI, ``python -m boslam_tpu_torch.main``, on the TUM-format
fixture ``tests/data/tum_mini``: the same bar as the JAX CLI's test in
tests/test_io.py (ATE < 5 cm, six poses in TUM format), and every pose
within 1 cm of the JAX engine's on the same frames; ``--async-mapping``
against the JAX engine's async run, and ``--mapping-device`` without a
card."""

import dataclasses
import json
import re

import numpy as np

import _torch_parity as tp

POSE_ATOL_M = 0.01


def _run_cli(tmp_path, *extra):
    """The port's CLI on tests/data/tum_mini at the fr1 preset patched to
    its 160x120 resolution: (completed process, trajectory path)."""
    out = str(tmp_path / "traj.txt")
    res = tp.run_cli("--tum", tp.TUM_MINI, "--out", out, "--device", "cpu",
                     *extra)
    return res, out


def test_cli_on_tum_mini_matches_jax_engine(tmp_path):
    """``python -m boslam_tpu_torch.main --tum`` on the 160x120 fixture of
    tests/test_io.py (the fr1 preset patched to its resolution), against the
    JAX engine on the same frames."""
    from boslam_tpu import config as j_config
    from boslam_tpu.io import tum as j_tum
    from boslam_tpu_torch.io import tum

    res, out = _run_cli(tmp_path)
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["device"] == "cpu" and summary["frames"] == 6
    assert summary["lost"] == 0 and summary["ate_rmse_m"] < 0.05
    _, poses = tum.load_trajectory(out)

    cam = dataclasses.replace(j_config.TUM_FR1, **tp.TUM_MINI_CAM)
    ref = tp.jax_engine(j_config.SlamConfig(camera=cam),
                        j_tum.sequence(str(tp.TUM_MINI),
                                       cam.depth_factor))
    _, est_ref = ref.trajectory()
    np.testing.assert_array_less(
        np.linalg.norm(poses[:, 4:] - est_ref[:, 4:], axis=1), POSE_ATOL_M)


def test_cli_global_ba_on_tum_mini(tmp_path):
    """``--global-ba``: global BA after the final flush, its line on stderr
    with cost1 <= cost0 over a positive edge count, and the trajectory it
    writes within the same ATE bar (< 5 cm)."""
    from boslam_tpu_torch.io import tum

    res, out = _run_cli(tmp_path, "--global-ba")
    m = re.search(r"global BA: cost ([0-9.]+) -> ([0-9.]+) \((\d+) edges\)",
                  res.stderr)
    assert m, res.stderr[-2000:]
    cost0, cost1, edges = float(m[1]), float(m[2]), int(m[3])
    assert edges > 0 and cost1 <= cost0
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["frames"] == 6 and summary["lost"] == 0
    assert summary["ate_rmse_m"] < 0.05
    _, poses = tum.load_trajectory(out)
    assert poses.shape == (6, 7) and np.all(np.isfinite(poses))


def test_cli_async_mapping_on_tum_mini_matches_jax_counts(tmp_path):
    """``--async-mapping``: the summary's counts are those the JAX CLI
    prints for its async run on the same frames (its engine with
    ``async_mapping=True``, frame by frame, summarized by the JAX module),
    the ATE within the same bar (< 5 cm)."""
    from boslam_tpu import config as j_config
    from boslam_tpu.io import tum as j_tum
    from boslam_tpu.slam import SlamSystem as JaxSlam
    from boslam_tpu.utils.metrics import summarize

    res, out = _run_cli(tmp_path, "--async-mapping")
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    cam = dataclasses.replace(j_config.TUM_FR1, **tp.TUM_MINI_CAM)
    ref = JaxSlam(j_config.SlamConfig(camera=cam), async_mapping=True)
    for f in j_tum.sequence(str(tp.TUM_MINI), cam.depth_factor, native=None):
        ref.process_frame(*f)
    ref.trajectory()
    want = summarize(ref.metrics)
    for k in ("n_frames", "n_keyframe_events", "n_lost", "n_loops"):
        assert summary[k] == want[k], k
    assert summary["keyframes"] == ref.n_keyframes
    assert summary["frames"] == 6 and summary["ate_rmse_m"] < 0.05


def test_cli_mapping_device_needs_a_card(tmp_path):
    """``--mapping-device N`` names a CUDA device: without a card the CLI
    fails with the device rule's error, also on a CPU engine."""
    res = tp.run_cli("--tum", tp.TUM_MINI, "--out", tmp_path / "t.txt",
                     "--device", "cpu", "--mapping-device", "0", check=False,
                     env={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "CUDA" in res.stderr.strip().splitlines()[-1]
