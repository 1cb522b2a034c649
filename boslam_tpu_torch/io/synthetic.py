"""Synthetic RGBD sequence renderer — the deterministic test/bench fixture.

No TUM/ICL data ships in this container (SURVEY.md §0 note; no network), so
this module renders a procedurally-textured room from arbitrary camera
trajectories with *exact* depth and groundtruth poses.  It plays the role of
the reference's TUM sequences for CI (SURVEY.md §4.2.4: "deterministic
mini-sequence fixture") and for the benchmark harness.

Host-side numpy; renders once per sequence, not on the device hot path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from boslam_tpu_torch.config import CameraConfig

# Room geometry: axis-aligned planes (normal axis, offset, inward sign).
# Camera starts near the origin looking down +z.
_PLANES = [
    (2, 6.0, -1.0),   # front wall  z = 6
    (2, -4.0, 1.0),   # back wall   z = -4
    (0, 4.0, -1.0),   # right wall  x = 4
    (0, -4.0, 1.0),   # left wall   x = -4
    (1, 2.0, -1.0),   # floor       y = 2
    (1, -2.0, 1.0),   # ceiling     y = -2
]


def _hash3(ix, iy, iz, seed):
    """Deterministic integer hash -> [0, 1) floats (vectorized)."""
    h = (
        ix.astype(np.int64) * 374761393
        + iy.astype(np.int64) * 668265263
        + iz.astype(np.int64) * 2147483647
        + np.int64(seed) * 144665
    )
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFF).astype(np.float32) / 65535.0


def _texture(p: np.ndarray, plane_id: int) -> np.ndarray:
    """Procedural gray texture at world points p[..., 3]: blocky random grids
    at two scales (sharp corners for FAST) plus a smooth gradient."""
    v = np.zeros(p.shape[:-1], np.float32)
    for scale, amp, seed in ((2.5, 0.55, 1), (7.0, 0.3, 7)):
        q = np.floor(p * scale).astype(np.int64)
        v += amp * _hash3(q[..., 0], q[..., 1], q[..., 2], seed + 31 * plane_id)
    v += 0.15 * ((p[..., 0] + p[..., 1]) * 0.05 % 1.0)
    return np.clip(v, 0.0, 1.0)


def render_frame(
    cam: CameraConfig, pose_twc: np.ndarray, room_scale: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Render (rgb u8 [H,W,3], depth f32 metres [H,W]) from a world pose T_wc.

    pose_twc: [7] = (qw qx qy qz tx ty tz); rays are cast through every pixel
    and intersected with the room's 6 planes; nearest hit wins.
    ``room_scale`` scales the room's plane offsets (texture texel size stays
    fixed in metres): >1 gives a hall-sized scene (the fr2/large class)
    where view overlap between path segments is low.
    """
    H, W = cam.height, cam.width
    qw, qx, qy, qz = pose_twc[:4]
    R = np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ],
        np.float32,
    )
    t = pose_twc[4:7].astype(np.float32)

    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    dirs_c = np.stack(
        [(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], axis=-1
    )
    dirs_w = dirs_c @ R.T  # [H, W, 3]

    best_t = np.full((H, W), np.inf, np.float32)
    gray = np.zeros((H, W), np.float32)
    for pid, (axis, off, sign) in enumerate(_PLANES):
        off = off * room_scale
        d = dirs_w[..., axis]
        denom = np.where(np.abs(d) < 1e-9, 1e-9, d)
        ray_t = (off - t[axis]) / denom
        valid = (ray_t > 1e-3) & (sign * d < 0)
        hit = valid & (ray_t < best_t)
        if not hit.any():
            continue
        pts = t + ray_t[..., None] * dirs_w
        tex = _texture(pts, pid)
        gray = np.where(hit, tex, gray)
        best_t = np.where(hit, ray_t, best_t)

    depth = np.where(np.isfinite(best_t), best_t * dirs_c[..., 2], 0.0)
    # dirs_c z == 1, so depth == ray_t along the z axis of the camera.
    depth = np.clip(depth, 0.0, cam.depth_max * 2)
    rgb = (gray[..., None].repeat(3, axis=-1) * 255).astype(np.uint8)
    return rgb, depth.astype(np.float32)


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _rotvec_to_quat(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.array([1.0, 0, 0, 0])
    ax = w / th
    return np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * ax])


@dataclass
class Trajectory:
    poses_twc: np.ndarray  # [N, 7]
    timestamps: np.ndarray  # [N]


def orbit_trajectory(
    n_frames: int,
    radius: float = 0.8,
    yaw_amplitude: float = 0.25,
    loop: bool = False,
    fps: float = 30.0,
) -> Trajectory:
    """Smooth trajectory: lateral arc + small yaw oscillation; ``loop=True``
    closes the path back to the start (loop-closure fixture)."""
    poses = []
    frac_end = 1.0 if loop else 0.5
    for i in range(n_frames):
        s = (i / max(n_frames - 1, 1)) * frac_end * 2 * np.pi
        tx = radius * np.sin(s)
        tz = radius * (1 - np.cos(s)) * 0.5
        ty = 0.1 * np.sin(2 * s)
        yaw = yaw_amplitude * np.sin(s)
        q = _rotvec_to_quat(np.array([0.0, yaw, 0.0]))
        poses.append(np.concatenate([q, [tx, ty, tz]]))
    ts = np.arange(n_frames) / fps
    return Trajectory(np.array(poses), ts)


def clover_trajectory(
    n_frames: int,
    n_petals: int = 2,
    radius: float = 0.8,
    yaw_amplitude: float = 0.25,
    fps: float = 30.0,
) -> Trajectory:
    """``n_petals`` closed excursions that each leave the start region and
    return to it (the fr2/large-with-loop class, BASELINE config 3).

    Each petal is a circle through the origin, the k-th rotated about the
    y axis by k * 2pi/(3*n_petals): petals explore DIFFERENT territory and
    only re-meet at the shared start, so a correct loop closer fires once
    per petal at spatially distinct places.  (A repeated traversal of ONE
    orbit cannot test this: after the first correction the map is merged
    and every later frame is covisible with it, suppressing candidates.)
    """
    poses = []
    for i in range(n_frames):
        s = (i / max(n_frames - 1, 1)) * n_petals  # in [0, n_petals]
        petal = min(int(s), n_petals - 1)
        f = s - petal
        # Smoothstep easing: the camera dwells near the shared origin at
        # petal boundaries, giving the loop closer several keyframes of
        # genuine revisit (temporal consistency needs consecutive hits).
        phi = 2 * np.pi * (3 * f * f - 2 * f * f * f)
        alpha = 2 * np.pi * petal / (3.0 * n_petals)
        # Circle through the origin in the xz-plane, rotated by alpha.
        px = radius * np.sin(phi)
        pz = radius * (1 - np.cos(phi)) * 0.5
        tx = np.cos(alpha) * px + np.sin(alpha) * pz
        tz = -np.sin(alpha) * px + np.cos(alpha) * pz
        ty = 0.1 * np.sin(2 * phi)
        yaw = yaw_amplitude * np.sin(phi)
        q = _rotvec_to_quat(np.array([0.0, yaw, 0.0]))
        poses.append(np.concatenate([q, [tx, ty, tz]]))
    ts = np.arange(n_frames) / fps
    return Trajectory(np.array(poses), ts)


def survey_trajectory(n_frames: int, span: float = 2.2,
                      fps: float = 30.0) -> Trajectory:
    """Exploratory scan of the whole room (the BASELINE config-4 map-scale
    workload): a lissajous position sweep plus one full 360-degree yaw turn,
    so most wall area is observed, at several distances.  Maximizes NOVEL
    viewpoints — keyframes are retained instead of culled as redundant and
    the map grows to tens of thousands of landmarks, unlike the orbit /
    clover fixtures whose revisits keep the map small."""
    poses = []
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        tx = span * np.sin(2 * np.pi * t)
        tz = 0.8 * span * np.sin(4 * np.pi * t) + 0.8
        ty = 0.5 * np.sin(6 * np.pi * t)
        yaw = 2 * np.pi * t
        pitch = 0.2 * np.sin(4 * np.pi * t)
        q = _quat_mul(
            _rotvec_to_quat(np.array([0.0, yaw, 0.0])),
            _rotvec_to_quat(np.array([pitch, 0.0, 0.0])),
        )
        q = q / np.linalg.norm(q)
        poses.append(np.concatenate([q, [tx, ty, tz]]))
    ts = np.arange(n_frames) / fps
    return Trajectory(np.array(poses), ts)


def random_walk_trajectory(
    n_frames: int, step_t: float = 0.02, step_r: float = 0.01, seed: int = 0,
    fps: float = 30.0,
) -> Trajectory:
    """Smoothed random-walk trajectory (fr1-style handheld motion)."""
    rng = np.random.default_rng(seed)
    q = np.array([1.0, 0, 0, 0])
    t = np.zeros(3)
    vel_t = np.zeros(3)
    vel_r = np.zeros(3)
    poses = []
    for _ in range(n_frames):
        vel_t = 0.9 * vel_t + step_t * rng.normal(size=3) * [1, 0.3, 1]
        vel_r = 0.9 * vel_r + step_r * rng.normal(size=3)
        t = np.clip(t + vel_t, [-2.5, -1.0, -2.5], [2.5, 1.0, 3.0])
        q = _quat_mul(q, _rotvec_to_quat(vel_r))
        q /= np.linalg.norm(q)
        poses.append(np.concatenate([q, t]))
    ts = np.arange(n_frames) / fps
    return Trajectory(np.array(poses), ts)


def render_sequence(
    cam: CameraConfig, traj: Trajectory, depth_noise: float = 0.0, seed: int = 0,
    room_scale: float = 1.0,
) -> List[Tuple[float, np.ndarray, np.ndarray]]:
    """Render a full sequence: list of (timestamp, rgb, depth)."""
    rng = np.random.default_rng(seed)
    frames = []
    for ts, pose in zip(traj.timestamps, traj.poses_twc):
        rgb, depth = render_frame(cam, pose, room_scale=room_scale)
        if depth_noise > 0:
            depth = depth + rng.normal(size=depth.shape).astype(np.float32) * (
                depth_noise * depth
            )
        frames.append((float(ts), rgb, depth))
    return frames
