"""The port's CLI, ``python -m boslam_tpu_torch.main``, on the TUM-format
fixture ``tests/data/tum_mini``: the same bar as the JAX CLI's test in
tests/test_io.py (ATE < 5 cm, six poses in TUM format), and every pose
within 1 cm of the JAX engine's on the same frames."""

import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

import _torch_parity as tp

ROOT = Path(__file__).resolve().parents[1]
POSE_ATOL_M = 0.01
SMALL = dict(width=160, height=120, fx=65.0, fy=65.0, cx=80.0, cy=60.0)


def _run_cli(tmp_path, *extra):
    """The port's CLI on tests/data/tum_mini at the fr1 preset patched to
    its 160x120 resolution: (completed process, trajectory path)."""
    root = str(ROOT / "tests" / "data" / "tum_mini")
    out = str(tmp_path / "traj.txt")
    argv = ["main", "--tum", root, "--out", out, "--device", "cpu", *extra]
    code = (
        "import sys, dataclasses, boslam_tpu_torch.config as C;"
        f"C.TUM_FR1 = dataclasses.replace(C.TUM_FR1, **{SMALL!r});"
        "from boslam_tpu_torch.main import main;"
        f"sys.argv = {argv!r}; main()"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
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

    cam = dataclasses.replace(j_config.TUM_FR1, **SMALL)
    ref = tp.jax_engine(j_config.SlamConfig(camera=cam),
                        j_tum.sequence(str(ROOT / "tests" / "data" / "tum_mini"),
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
