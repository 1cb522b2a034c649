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


def _run_both(module, patch, runs):
    """Each argv of ``runs`` through ``MODULE.main`` in turn, in ONE
    subprocess (the JAX CLI compiles its frame step once), with ``patch``
    run first; returns each run's stdout and stderr."""
    import os
    import subprocess
    import sys

    code = (
        "import io, sys, contextlib, dataclasses, json\n"
        f"{patch}\n"
        f"from {module}.main import main\n"
        "outs = []\n"
        f"for argv in {[[str(a) for a in r] for r in runs]!r}:\n"
        "    o, e = io.StringIO(), io.StringIO()\n"
        "    sys.argv = ['main', *argv]\n"
        "    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):\n"
        "        main()\n"
        "    outs.append((o.getvalue(), e.getvalue()))\n"
        "print(json.dumps(outs))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=tp.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_cli_resume_feeds_again_like_jax_cli(tmp_path):
    """``--synthetic 10 --checkpoint-every 1`` then ``--resume``, on both
    CLIs at 160x120, each from its own checkpoint: the port's restored
    engine is fed the sequence again from frame 0, as the reference's is,
    so its summary's frames (checkpoint frames + 10), keyframes and lost
    frames equal the JAX CLI's (the JAX engine's keyframe count is printed
    by a wrapper of its ``trajectory``)."""
    n = 10
    cam = f"C.TUM_FR1 = dataclasses.replace(C.TUM_FR1, **{tp.TUM_MINI_CAM!r})"
    first = ["--synthetic", n, "--checkpoint-every", 1]
    port = _run_both(
        "boslam_tpu_torch", f"import boslam_tpu_torch.config as C; {cam}",
        [first + ["--device", "cpu", "--out", tmp_path / "a.txt",
                  "--checkpoint-dir", tmp_path / "ck_t"],
         ["--synthetic", n, "--device", "cpu", "--out", tmp_path / "b.txt",
          "--resume", tmp_path / "ck_t"]])
    got = json.loads(port[1][0].strip().splitlines()[-1])
    jax = _run_both(
        "boslam_tpu",
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        f"import boslam_tpu.config as C; {cam}\n"
        "import boslam_tpu.slam as S\n"
        "_tr = S.SlamSystem.trajectory\n"
        "def trajectory(self):\n"
        "    print('KEYFRAMES', self.n_keyframes, file=sys.stderr)\n"
        "    return _tr(self)\n"
        "S.SlamSystem.trajectory = trajectory",
        [first + ["--out", tmp_path / "ja.txt",
                  "--checkpoint-dir", tmp_path / "ck_j"],
         ["--synthetic", n, "--out", tmp_path / "jb.txt",
          "--resume", tmp_path / "ck_j"]])
    want = json.loads(jax[1][0].strip().splitlines()[-1])
    frames = int(re.findall(r"wrote (\d+) poses", jax[1][1])[-1])
    kfs = int(re.findall(r"KEYFRAMES (\d+)", jax[1][1])[-1])
    assert "resumed from" in port[1][1] and "resumed from" in jax[1][1]
    assert n < frames < 2 * n
    assert got["frames"] == frames
    assert got["n_frames"] == want["n_frames"] == n
    assert got["keyframes"] == kfs
    assert got["lost"] == want["n_lost"]
    assert np.isfinite(got["ate_rmse_m"])
