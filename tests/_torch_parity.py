"""Shared set-up for the parity tests of the PyTorch port against the JAX
package (``tests/test_torch_*.py``): one config dict builds both packages'
configs, inputs are made with numpy from a seed, and JAX state reaches the
port through ``boslam_tpu_torch.convert`` as numpy arrays."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import jax.numpy as jnp

from boslam_tpu.config import SlamConfig as JaxConfig
from boslam_tpu_torch.config import SlamConfig as TorchConfig

# Each xdist worker runs one test file; keep its torch pool small.
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CAM = dict(width=320, height=240, fx=130.0, fy=130.0, cx=160.0, cy=120.0)
# The configuration of tests/test_slam_e2e.py.
E2E = {"camera": CAM, "orb": dict(n_features=256, n_levels=4),
       "loop": dict(min_gap_kf=6, consistency=2)}
# The same with small map capacities, for the per-module tests.
SMALL = dict(E2E, map=dict(max_keyframes=32, max_points=4096))


def configs(d):
    return JaxConfig.from_dict(d), TorchConfig.from_dict(d)


def np_dict(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def t(a, dtype=None) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    out = torch.from_numpy(a)
    return out if dtype is None else out.to(dtype)


def orbit_frames(cam_cfg, n: int, **kw):
    from boslam_tpu_torch.io import synthetic

    traj = synthetic.orbit_trajectory(n, radius=0.5, yaw_amplitude=0.2)
    return traj, synthetic.render_sequence(cam_cfg, traj, **kw)


def wire(cfg, rgb, depth):
    """The engine's wire format: u8 gray and u16 depth, then f32 working
    arrays (gray [0, 255], depth metres) exactly as frame_step_core does."""
    from boslam_tpu_torch.slam import depth_wire, to_gray_u8

    g = to_gray_u8(rgb)
    d16 = depth_wire(depth, cfg.camera)
    gray = g.astype(np.float32)
    depth_m = d16.astype(np.float32) * np.float32(1.0 / cfg.camera.depth_factor)
    return g, d16, gray, depth_m


def jax_engine(cfg_j, frames):
    """The JAX SlamSystem with loop verification off, fed ``frames``."""
    from boslam_tpu.slam import SlamSystem

    slam = SlamSystem(cfg_j)
    slam.MAX_VERIFY = 0
    for f in frames:
        slam.feed(*f)
    slam.flush()
    return slam


def port_engine(cfg_t, frames, vocab_ready=None):
    """The port's SlamSystem on the CPU with loop verification off, fed
    ``frames``; ``vocab_ready``, a list, gets what each frame's step saw."""
    from boslam_tpu_torch.slam import SlamSystem

    slam = SlamSystem(cfg_t, device="cpu")
    slam.MAX_VERIFY = 0
    for f in frames:
        if vocab_ready is not None:
            vocab_ready.append(bool(slam.loop.vocab_ready))
        slam.feed(*f)
    slam.flush()
    return slam


def blank(frames, indices):
    """``frames`` with the frames ``indices`` black and without depth."""
    out = list(frames)
    for i in indices:
        ts, rgb, depth = out[i]
        out[i] = (ts, np.zeros_like(rgb), np.zeros_like(depth))
    return out


def jax_features(cfg_j, rgb, depth):
    from boslam_tpu.features import extract_features

    _, _, gray, depth_m = wire(cfg_j, rgb, depth)
    return extract_features(jnp.asarray(gray), jnp.asarray(depth_m), cfg_j)


def scenario(d, n_fed: int):
    """JAX engine state after ``n_fed`` frames of the orbit, and the JAX
    features of the next frame: (cfg_j, cfg_t, jax SlamSystem, feats_j)."""
    cfg_j, cfg_t = configs(d)
    _, frames = orbit_frames(cfg_t.camera, n_fed + 1, depth_noise=0.01, seed=2)
    slam = jax_engine(cfg_j, frames[:n_fed])
    feats = jax_features(cfg_j, frames[n_fed][1], frames[n_fed][2])
    return cfg_j, cfg_t, slam, feats


def port_state(nt, cls_from_numpy):
    """A JAX NamedTuple carried into the port on the CPU."""
    return cls_from_numpy(np_dict(nt), "cpu")


def assert_state_close(ref, got, atol=1e-5, loose=(), loose_atol=1e-4):
    """Field by field: integer and bool fields exact, float fields within
    ``atol`` (``loose_atol`` for the fields named in ``loose``)."""
    ref_d = np_dict(ref)
    for k, want in ref_d.items():
        have = getattr(got, k).detach().cpu().numpy()
        if want.dtype == np.uint32:
            have = have.view(np.uint32)
        assert have.shape == want.shape, k
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(
                have, want, rtol=0, atol=loose_atol if k in loose else atol,
                err_msg=k)
        else:
            np.testing.assert_array_equal(have, want, err_msg=k)


ROOT = Path(__file__).resolve().parents[1]
TUM_MINI = ROOT / "tests" / "data" / "tum_mini"
# The resolution of tests/data/tum_mini, patched into the fr1 preset.
TUM_MINI_CAM = dict(width=160, height=120, fx=65.0, fy=65.0, cx=80.0, cy=60.0)


def run_cli(*argv, check: bool = True, env=None):
    """``python -m boslam_tpu_torch.main ARGV`` in a subprocess (``env``
    added to its environment), with the fr1 preset patched to tum_mini's
    160x120 camera; returns the completed process (its return code 0
    asserted unless ``check`` is False)."""
    argv = ["main", *map(str, argv)]
    code = (
        "import sys, dataclasses, boslam_tpu_torch.config as C;"
        f"C.TUM_FR1 = dataclasses.replace(C.TUM_FR1, **{TUM_MINI_CAM!r});"
        "from boslam_tpu_torch.main import main;"
        f"sys.argv = {argv!r}; main()"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, **(env or {})),
                         capture_output=True, text=True, timeout=300)
    if check:
        assert res.returncode == 0, res.stderr[-2000:]
    return res
