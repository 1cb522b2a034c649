"""The port's CLI, ``python -m boslam_tpu_torch.main``, on the TUM-format
fixture ``tests/data/tum_mini``: the same bar as the JAX CLI's test in
tests/test_io.py (ATE < 5 cm, six poses in TUM format), and every pose
within 1 cm of the JAX engine's on the same frames."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import _torch_parity as tp

ROOT = Path(__file__).resolve().parents[1]
POSE_ATOL_M = 0.01


def test_cli_on_tum_mini_matches_jax_engine(tmp_path):
    """``python -m boslam_tpu_torch.main --tum`` on the 160x120 fixture of
    tests/test_io.py (the fr1 preset patched to its resolution), against the
    JAX engine on the same frames."""
    from boslam_tpu import config as j_config
    from boslam_tpu.io import tum as j_tum
    from boslam_tpu_torch.io import tum

    root = str(ROOT / "tests" / "data" / "tum_mini")
    out = str(tmp_path / "traj.txt")
    small = dict(width=160, height=120, fx=65.0, fy=65.0, cx=80.0, cy=60.0)
    code = (
        "import sys, dataclasses, boslam_tpu_torch.config as C;"
        f"C.TUM_FR1 = dataclasses.replace(C.TUM_FR1, **{small!r});"
        "from boslam_tpu_torch.main import main;"
        f"sys.argv = ['main', '--tum', {root!r}, '--out', {out!r},"
        " '--device', 'cpu']; main()"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["device"] == "cpu" and summary["frames"] == 6
    assert summary["lost"] == 0 and summary["ate_rmse_m"] < 0.05
    _, poses = tum.load_trajectory(out)

    cam = dataclasses.replace(j_config.TUM_FR1, **small)
    ref = tp.jax_engine(j_config.SlamConfig(camera=cam),
                        j_tum.sequence(root, cam.depth_factor))
    _, est_ref = ref.trajectory()
    np.testing.assert_array_less(
        np.linalg.norm(poses[:, 4:] - est_ref[:, 4:], axis=1), POSE_ATOL_M)
