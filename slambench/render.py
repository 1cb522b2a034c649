"""The benchmark's RGB-D sequences: camera paths and a ray-cast room.

Frozen copy of ``boslam_tpu_torch/io/synthetic.py`` (``_PLANES``,
``_hash3``, ``_texture``, ``render_frame``, ``_quat_mul``,
``_rotvec_to_quat``, ``orbit_trajectory``, ``clover_trajectory``,
``survey_trajectory``) and of ``boslam_tpu_torch/slam.py``
(``depth_to_u16``, ``depth_wire``) at commit bd2752c.  The numpy renderer
is kept as ``render_frame_np``; ``render_wire`` is the same ray cast
rewritten in PyTorch so that it runs on the card (a numpy frame costs about
a quarter of a second on the host), and it ends in the engine's wire format
(u8 gray, u16 depth at the camera's wire stride) on the host.  Nothing
here imports the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Room geometry: axis-aligned planes (normal axis, offset, inward sign).
PLANES = [
    (2, 6.0, -1.0),   # front wall  z = 6
    (2, -4.0, 1.0),   # back wall   z = -4
    (0, 4.0, -1.0),   # right wall  x = 4
    (0, -4.0, 1.0),   # left wall   x = -4
    (1, 2.0, -1.0),   # floor       y = 2
    (1, -2.0, 1.0),   # ceiling     y = -2
]


@dataclass(frozen=True)
class Camera:
    """The pinhole fields the renderer and the wire format need."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    depth_factor: float
    depth_max: float
    depth_wire_stride: int

    @classmethod
    def from_config(cls, slam_cfg: dict) -> "Camera":
        c = slam_cfg["camera"]
        return cls(*(c[f] for f in cls.__dataclass_fields__))

    @property
    def wire_shape(self) -> tuple:
        s = self.depth_wire_stride
        return (-(-self.height // s), -(-self.width // s))


@dataclass
class Trajectory:
    poses_twc: np.ndarray  # [N, 7] (qw qx qy qz tx ty tz), camera to world
    timestamps: np.ndarray  # [N]


# ---------------------------------------------------------------------------
# Camera paths (numpy, as in the original)
# ---------------------------------------------------------------------------


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _rotvec_to_quat(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.array([1.0, 0, 0, 0])
    ax = w / th
    return np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * ax])


def orbit_trajectory(n_frames, radius=0.8, yaw_amplitude=0.25, loop=False,
                     fps=30.0):
    poses = []
    frac_end = 1.0 if loop else 0.5
    for i in range(n_frames):
        s = (i / max(n_frames - 1, 1)) * frac_end * 2 * np.pi
        tx = radius * np.sin(s)
        tz = radius * (1 - np.cos(s)) * 0.5
        ty = 0.1 * np.sin(2 * s)
        q = _rotvec_to_quat(np.array([0.0, yaw_amplitude * np.sin(s), 0.0]))
        poses.append(np.concatenate([q, [tx, ty, tz]]))
    return Trajectory(np.array(poses), np.arange(n_frames) / fps)


def clover_trajectory(n_frames, n_petals=2, radius=0.8, yaw_amplitude=0.25,
                      fps=30.0):
    """``n_petals`` closed excursions that leave the start and return to it
    (the fr2/large-with-loop class)."""
    poses = []
    for i in range(n_frames):
        s = (i / max(n_frames - 1, 1)) * n_petals
        petal = min(int(s), n_petals - 1)
        f = s - petal
        phi = 2 * np.pi * (3 * f * f - 2 * f * f * f)
        alpha = 2 * np.pi * petal / (3.0 * n_petals)
        px = radius * np.sin(phi)
        pz = radius * (1 - np.cos(phi)) * 0.5
        tx = np.cos(alpha) * px + np.sin(alpha) * pz
        tz = -np.sin(alpha) * px + np.cos(alpha) * pz
        ty = 0.1 * np.sin(2 * phi)
        q = _rotvec_to_quat(np.array([0.0, yaw_amplitude * np.sin(phi), 0.0]))
        poses.append(np.concatenate([q, [tx, ty, tz]]))
    return Trajectory(np.array(poses), np.arange(n_frames) / fps)


def survey_trajectory(n_frames, span=2.2, fps=30.0):
    """A lissajous sweep with one full turn of yaw: mostly novel views, so
    the map grows instead of being culled."""
    poses = []
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        tx = span * np.sin(2 * np.pi * t)
        tz = 0.8 * span * np.sin(4 * np.pi * t) + 0.8
        ty = 0.5 * np.sin(6 * np.pi * t)
        yaw = 2 * np.pi * t
        pitch = 0.2 * np.sin(4 * np.pi * t)
        q = _quat_mul(_rotvec_to_quat(np.array([0.0, yaw, 0.0])),
                      _rotvec_to_quat(np.array([pitch, 0.0, 0.0])))
        q = q / np.linalg.norm(q)
        poses.append(np.concatenate([q, [tx, ty, tz]]))
    return Trajectory(np.array(poses), np.arange(n_frames) / fps)


TRAJECTORIES = {"orbit": orbit_trajectory, "clover": clover_trajectory,
                "survey": survey_trajectory}


def trajectory(spec: dict) -> Trajectory:
    """The path a traffic file names: ``{"path": name, **kwargs}``."""
    kw = dict(spec)
    return TRAJECTORIES[kw.pop("path")](**kw)


def _rotation_np(pose_twc) -> np.ndarray:
    qw, qx, qy, qz = pose_twc[:4]
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ], np.float32)


# ---------------------------------------------------------------------------
# The numpy renderer (the original, for the tests)
# ---------------------------------------------------------------------------


def _hash3_np(ix, iy, iz, seed):
    h = (ix.astype(np.int64) * 374761393 + iy.astype(np.int64) * 668265263
         + iz.astype(np.int64) * 2147483647 + np.int64(seed) * 144665)
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFF).astype(np.float32) / 65535.0


def _texture_np(p, plane_id):
    v = np.zeros(p.shape[:-1], np.float32)
    for scale, amp, seed in ((2.5, 0.55, 1), (7.0, 0.3, 7)):
        q = np.floor(p * scale).astype(np.int64)
        v += amp * _hash3_np(q[..., 0], q[..., 1], q[..., 2],
                             seed + 31 * plane_id)
    v += 0.15 * ((p[..., 0] + p[..., 1]) * 0.05 % 1.0)
    return np.clip(v, 0.0, 1.0)


def render_frame_np(cam: Camera, pose_twc, room_scale=1.0):
    """(rgb u8 [H, W, 3], depth f32 metres [H, W]) from a pose T_wc."""
    H, W = cam.height, cam.width
    R = _rotation_np(pose_twc)
    t = pose_twc[4:7].astype(np.float32)
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    dirs_c = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                       np.ones_like(u)], axis=-1)
    dirs_w = dirs_c @ R.T
    best_t = np.full((H, W), np.inf, np.float32)
    gray = np.zeros((H, W), np.float32)
    for pid, (axis, off, sign) in enumerate(PLANES):
        off = off * room_scale
        d = dirs_w[..., axis]
        denom = np.where(np.abs(d) < 1e-9, 1e-9, d)
        ray_t = (off - t[axis]) / denom
        valid = (ray_t > 1e-3) & (sign * d < 0)
        hit = valid & (ray_t < best_t)
        if not hit.any():
            continue
        pts = t + ray_t[..., None] * dirs_w
        gray = np.where(hit, _texture_np(pts, pid), gray)
        best_t = np.where(hit, ray_t, best_t)
    depth = np.where(np.isfinite(best_t), best_t * dirs_c[..., 2], 0.0)
    depth = np.clip(depth, 0.0, cam.depth_max * 2)
    rgb = (gray[..., None].repeat(3, axis=-1) * 255).astype(np.uint8)
    return rgb, depth.astype(np.float32)


def depth_wire_np(depth, cam: Camera):
    """f32 metres -> wire-format u16 at ``cam.wire_shape``: one sample per
    s x s block, the medoid of the block's valid samples picks a surface and
    the samples within 5 % of it are averaged."""
    buf = depth * np.float32(cam.depth_factor)
    np.clip(buf, 0, 65535, out=buf)
    depth = buf.astype(np.uint16)
    s = cam.depth_wire_stride
    if s == 1:
        return depth
    hs, ws = cam.wire_shape
    H, W = depth.shape
    buf = np.zeros((hs * s, ws * s), np.float32)
    buf[:H, :W] = depth
    b = buf.reshape(hs, s, ws, s).transpose(0, 2, 1, 3).reshape(hs, ws, s * s)
    valid = b > 0
    c = valid.sum(-1)
    sv = np.sort(np.where(valid, b, np.inf), axis=-1)
    med = np.take_along_axis(sv, (np.maximum(c - 1, 0) // 2)[..., None],
                             axis=-1)[..., 0]
    keep = valid & (np.abs(b - med[..., None]) <= 0.05 * med[..., None])
    out = (b * keep).sum(-1) / np.maximum(keep.sum(-1), 1)
    return np.rint(np.where(c > 0, out, 0.0)).astype(np.uint16)


# ---------------------------------------------------------------------------
# The same ray cast in PyTorch
# ---------------------------------------------------------------------------


def _hash3(ix, iy, iz, seed: int):
    h = ix * 374761393 + iy * 668265263 + iz * 2147483647 + seed * 144665
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFF).to(torch.float32) / 65535.0


def _texture(p, plane_id: int):
    v = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    for scale, amp, seed in ((2.5, 0.55, 1), (7.0, 0.3, 7)):
        q = torch.floor(p * scale).to(torch.int64)
        v = v + amp * _hash3(q[..., 0], q[..., 1], q[..., 2],
                             seed + 31 * plane_id)
    v = v + 0.15 * torch.remainder((p[..., 0] + p[..., 1]) * 0.05, 1.0)
    return torch.clamp(v, 0.0, 1.0)


def render_frame(cam: Camera, pose_twc, room_scale: float, device):
    """(gray f32 in [0, 1] [H, W], depth f32 metres [H, W]) on ``device``:
    ``render_frame_np`` with the rotation applied element by element, so
    that no matrix product (and no TF32) is involved."""
    H, W = cam.height, cam.width
    R = _rotation_np(pose_twc)
    t = pose_twc[4:7].astype(np.float32)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    dc = ((u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, torch.ones_like(u))
    dirs_w = torch.stack([dc[0] * float(R[i, 0]) + dc[1] * float(R[i, 1])
                          + dc[2] * float(R[i, 2]) for i in range(3)], -1)
    t_dev = torch.from_numpy(t).to(device)
    best_t = torch.full((H, W), float("inf"), device=device)
    gray = torch.zeros((H, W), device=device)
    for pid, (axis, off, sign) in enumerate(PLANES):
        # A tensor numerator: a Python one divides by way of a reciprocal.
        num = torch.tensor(np.float32(off * room_scale) - t[axis],
                           device=device)
        d = dirs_w[..., axis]
        denom = torch.where(torch.abs(d) < 1e-9, 1e-9, d)
        ray_t = num / denom
        hit = (ray_t > 1e-3) & (sign * d < 0) & (ray_t < best_t)
        pts = t_dev + ray_t[..., None] * dirs_w
        gray = torch.where(hit, _texture(pts, pid), gray)
        best_t = torch.where(hit, ray_t, best_t)
    depth = torch.where(torch.isfinite(best_t), best_t, 0.0)
    return gray, torch.clamp(depth, 0.0, cam.depth_max * 2)


def depth_wire(depth, cam: Camera):
    """``depth_wire_np`` in PyTorch; int32 counts at ``cam.wire_shape``."""
    d16 = torch.clamp(depth * np.float32(cam.depth_factor), 0, 65535).to(
        torch.int32)
    s = cam.depth_wire_stride
    if s == 1:
        return d16
    hs, ws = cam.wire_shape
    H, W = d16.shape
    buf = torch.zeros((hs * s, ws * s), device=depth.device)
    buf[:H, :W] = d16.to(torch.float32)
    b = buf.reshape(hs, s, ws, s).permute(0, 2, 1, 3).reshape(hs, ws, s * s)
    valid = b > 0
    c = valid.sum(-1)
    sv = torch.sort(torch.where(valid, b, float("inf")), dim=-1).values
    med = torch.gather(sv, -1, (torch.clamp(c - 1, min=0) // 2)[..., None])
    keep = valid & (torch.abs(b - med) <= 0.05 * med)
    out = (b * keep).sum(-1) / torch.clamp(keep.sum(-1), min=1)
    return torch.round(torch.where(c > 0, out, 0.0)).to(torch.int32)


def render_wire(cam: Camera, traj: Trajectory, *, depth_noise: float,
                room_scale: float, generator: torch.Generator, device):
    """Every pose of ``traj`` as an engine wire frame on the host:
    ``(ts, u8 gray [H, W], u16 depth at the wire shape)``.  The depth noise
    (``depth_noise`` x depth, Gaussian) is drawn from ``generator`` in frame
    order."""
    out = []
    for ts, pose in zip(traj.timestamps, traj.poses_twc):
        gray, depth = render_frame(cam, pose, room_scale, device)
        if depth_noise > 0:
            noise = torch.randn(depth.shape, generator=generator,
                                device=device)
            depth = depth + noise * (depth_noise * depth)
        g8 = (gray * 255).to(torch.uint8)
        out.append((float(ts), g8.cpu().numpy(),
                    depth_wire(depth, cam).cpu().numpy().astype(np.uint16)))
    return out
