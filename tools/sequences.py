"""Named synthetic RGBD sequences, the same frames for either package.

Each entry is a config dict (``SlamConfig.from_dict``), a trajectory of
``io.synthetic`` and its render recipe.  ``build`` takes the package's own
``SlamConfig`` class and ``synthetic`` module, so the JAX reference tool
and the port's tools render identical frames without either importing the
other.

* ``orbit``: the sequence of ``chip_smoke.py`` phase 3 — default
  full-width ``SlamConfig()`` (640x480 TUM fr1 camera, 512 features, 8
  levels) on a 120-frame orbit, 1% depth noise.
* ``hall``: the bench's tracking run (``bench.py``: ``_tracking_cfg`` and
  its ``RenderFeed``) — the 450-frame 3-petal clover in a hall-sized room
  (room scale 2.5), a wide-FOV VGA camera, 2.5% depth noise, depth on the
  wire at stride 2.  Run with loops off, it is ROADMAP A5's bar; with
  loops on, A6's.
* ``kidnap``: the ``orbit`` with ``map.max_points = 65536`` (the capacity
  ``bench.py`` gives its engine-built map) and frames 8, 9, 70 and 71
  blanked (gray 0, depth 0).  The first gap loses tracking before the first
  flush can train the vocabulary, so relocalization takes the whole-map
  path through kernel B3; the second relocalizes through BoW.
* ``loop``: the first 320 frames of ``hall``.  With loops on, the JAX
  reference closes one loop there (at the keyframe of frame 291, verified
  one flush late).
* ``survey``: the bench's engine-built global-BA map
  (``bench.py:bench_tracked_global_ba``): a 400-frame survey of a room at
  scale 3.0 with the wide-FOV VGA camera (depth range 30 m), 1024
  features, a 256-keyframe / 65536-point map that culls no keyframe as
  redundant, a keyframe at least every 6 frames, 1% depth noise.  The
  bench runs it with loops on, then one global BA.
"""

from __future__ import annotations

import numpy as np

SEQUENCES = {
    "orbit": dict(
        cfg={},
        trajectory=("orbit_trajectory",
                    dict(n_frames=120, radius=0.6, yaw_amplitude=0.3)),
        render=dict(depth_noise=0.01, seed=0),
    ),
    "hall": dict(
        cfg=dict(
            camera=dict(fx=260.0, fy=260.0, cx=319.5, cy=239.5,
                        depth_max=20.0, depth_wire_stride=2),
            loop=dict(min_gap_kf=8, consistency=2),
            tracker=dict(kf_min_interval=2, kf_tracked_ratio=0.8),
        ),
        trajectory=("clover_trajectory",
                    dict(n_frames=450, n_petals=3, radius=2.5,
                         yaw_amplitude=0.4)),
        render=dict(depth_noise=0.025, seed=3, room_scale=2.5),
    ),
    "kidnap": dict(
        cfg=dict(map=dict(max_points=65536)),
        trajectory=("orbit_trajectory",
                    dict(n_frames=120, radius=0.6, yaw_amplitude=0.3)),
        render=dict(depth_noise=0.01, seed=0),
        blank=(8, 9, 70, 71),
    ),
    "survey": dict(
        cfg=dict(
            camera=dict(fx=260.0, fy=260.0, cx=319.5, cy=239.5,
                        depth_max=30.0),
            orb=dict(n_features=1024),
            map=dict(max_keyframes=256, max_points=65536,
                     kf_cull_redundancy=2.0),
            loop=dict(min_gap_kf=8, consistency=2),
            tracker=dict(kf_min_interval=2, kf_max_interval=6,
                         kf_tracked_ratio=0.8),
        ),
        trajectory=("survey_trajectory", dict(n_frames=400, span=6.0)),
        render=dict(depth_noise=0.01, seed=5, room_scale=3.0),
    ),
}
# The closed orbit of tests/test_slam_e2e.py's loop test at full width
# closes no loop in the JAX reference, in one lap or two (its consistent
# candidates stay under the 77-inlier gate of 512 features), so ``loop`` is
# the hall clover cut after its first closure.
SEQUENCES["loop"] = dict(SEQUENCES["hall"], frames=320)


def blank_frames(frames, indices):
    """Frames ``indices`` replaced by a black image with no depth."""
    out = list(frames)
    for i in indices:
        if i < len(out):
            ts, rgb, depth = out[i]
            out[i] = (ts, np.zeros_like(rgb), np.zeros_like(depth))
    return out


def build(name: str, config_cls, synthetic, n_frames: int | None = None):
    """(cfg, trajectory, frames) of sequence ``name``; ``n_frames`` keeps the
    first frames only (the same frames the full sequence starts with)."""
    seq = SEQUENCES[name]
    cfg = config_cls.from_dict(seq["cfg"])
    fn, kw = seq["trajectory"]
    traj = getattr(synthetic, fn)(**kw)
    n_frames = seq.get("frames") if n_frames is None else n_frames
    if n_frames is not None:
        traj.poses_twc = traj.poses_twc[:n_frames]
        traj.timestamps = traj.timestamps[:n_frames]
    frames = synthetic.render_sequence(cfg.camera, traj, **seq["render"])
    return cfg, traj, blank_frames(frames, seq.get("blank", ()))
