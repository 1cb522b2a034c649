"""Pinhole RGBD camera model on torch tensors.

Backprojection follows ``X = D(u, v) / depth_factor * K^{-1} [u, v, 1]``;
depth tensors are already in metres when they reach these functions.
"""

from __future__ import annotations

import torch

from boslam_tpu_torch.config import CameraConfig


def intrinsics(cam: CameraConfig, device=None):
    return torch.tensor(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
        device=device,
    )


def project(cam: CameraConfig, xc):
    """Camera-frame points [..., 3] -> pixel coords [..., 2] (u, v).

    No validity clamp here; callers mask on z > 0 and image bounds.
    """
    z = xc[..., 2:3]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * xc[..., 0:1] / zs + cam.cx
    v = cam.fy * xc[..., 1:2] / zs + cam.cy
    return torch.cat([u, v], dim=-1)


def backproject(cam: CameraConfig, uv, z):
    """Pixels [..., 2] + depth [...] -> camera-frame points [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx * z
    y = (uv[..., 1] - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1)


def in_image(cam: CameraConfig, uv, border: float = 0.0):
    return (
        (uv[..., 0] >= border)
        & (uv[..., 0] < cam.width - border)
        & (uv[..., 1] >= border)
        & (uv[..., 1] < cam.height - border)
    )


def valid_depth(cam: CameraConfig, z):
    return (z > cam.depth_min) & (z < cam.depth_max)


def project_jacobian(cam: CameraConfig, xc):
    """d(u,v)/d(xc): [..., 2, 3] for camera-frame points."""
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / zs
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)
