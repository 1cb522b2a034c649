"""SE(3) / quaternion geometry on batched torch tensors.

Poses are flat ``[..., 7]`` tensors ``(qw, qx, qy, qz, tx, ty, tz)``
(Hamilton convention, unit quaternion), the layout of
``boslam_tpu.geometry.se3``.  A pose ``T`` acts on points as ``x' = R x + t``;
camera poses are stored as ``T_cw`` (world -> camera).

Twist vectors are ``[..., 6] = (omega[3], v[3])``, rotation first; ``exp`` /
``log`` use the exact closed forms with Taylor branches for small angles.
"""

from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# Quaternions (Hamilton, w-first)
# ---------------------------------------------------------------------------


def quat_identity(shape=(), device=None):
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vectors ``v[..., 3]`` by unit quaternions ``q[..., 4]``."""
    qv = q[..., 1:]
    qw = q[..., :1]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m):
    """Rotation matrix -> unit quaternion, branchless (Shepperd's method)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1)
    cases = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4, 4]
    scores = torch.stack(
        [tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1
    )
    idx = torch.argmax(scores, dim=-1)
    q = torch.gather(
        cases, -2, idx[..., None, None].expand(idx.shape + (1, 4))
    )[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def so3_exp_quat(omega):
    """Rotation vector [..., 3] -> unit quaternion."""
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    small = theta2 < 1e-12
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([w, k * omega], dim=-1))


def so3_log(q):
    """Unit quaternion -> rotation vector [..., 3]."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vn2 = torch.sum(q[..., 1:] ** 2, dim=-1, keepdim=True)
    small = vn2 < 1e-16
    vn = torch.sqrt(torch.where(small, 1.0, vn2))
    theta = 2.0 * torch.atan2(vn, w)
    k = torch.where(small, 2.0 / torch.clamp(w, min=1e-12), theta / vn)
    return k * q[..., 1:]


def hat(v):
    """Skew-symmetric matrix of [..., 3]."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SE(3) poses as [..., 7] = (q, t)
# ---------------------------------------------------------------------------


def pose_identity(shape=(), device=None):
    p = torch.zeros(tuple(shape) + (7,), device=device)
    p[..., 0] = 1.0
    return p


def make_pose(q, t):
    batch = torch.broadcast_shapes(q.shape[:-1], t.shape[:-1])
    return torch.cat([q.expand(batch + (4,)), t.expand(batch + (3,))], dim=-1)


def rotation(p):
    return p[..., :4]


def translation(p):
    return p[..., 4:]


def pose_apply(p, x):
    """Apply pose(s) to points ``x[..., 3]``: R x + t."""
    return quat_rotate(p[..., :4], x) + p[..., 4:]


def pose_compose(a, b):
    """(a ∘ b)(x) = a(b(x))."""
    q = quat_mul(a[..., :4], b[..., :4])
    t = quat_rotate(a[..., :4], b[..., 4:]) + a[..., 4:]
    return make_pose(quat_normalize(q), t)


def pose_inv(p):
    qi = quat_conj(p[..., :4])
    return make_pose(qi, -quat_rotate(qi, p[..., 4:]))


def pose_to_mat(p):
    """[..., 7] -> homogeneous [..., 4, 4]."""
    m = torch.zeros(p.shape[:-1] + (4, 4), dtype=p.dtype, device=p.device)
    m[..., :3, :3] = quat_to_mat(p[..., :4])
    m[..., :3, 3] = p[..., 4:]
    m[..., 3, 3] = 1.0
    return m


def mat_to_pose(m):
    return make_pose(mat_to_quat(m[..., :3, :3]), m[..., :3, 3])


def _so3_left_jacobian(omega):
    """V(omega) such that exp(omega, v) has translation V v."""
    theta2 = torch.sum(omega * omega, dim=-1)[..., None, None]
    small = theta2 < 1e-12
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    W = hat(omega)
    W2 = W @ W
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    b = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2_safe * theta),
    )
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(W.shape)
    return eye + a * W + b * W2


def _so3_left_jacobian_inv(omega):
    theta2 = torch.sum(omega * omega, dim=-1)[..., None, None]
    small = theta2 < 1e-12
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    W = hat(omega)
    W2 = W @ W
    sin_safe = torch.where(torch.abs(torch.sin(theta)) < 1e-7, 1e-7,
                           torch.sin(theta))
    cot = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / theta2_safe - (1.0 + torch.cos(theta)) / (2.0 * theta * sin_safe),
    )
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(W.shape)
    return eye - 0.5 * W + cot * W2


def exp(xi):
    """se(3) twist ``[..., 6] = (omega, v)`` -> pose [..., 7]."""
    omega, v = xi[..., :3], xi[..., 3:]
    q = so3_exp_quat(omega)
    V = _so3_left_jacobian(omega)
    t = torch.einsum("...ij,...j->...i", V, v)
    return make_pose(q, t)


def log(p):
    """Pose [..., 7] -> twist [..., 6] = (omega, v)."""
    omega = so3_log(p[..., :4])
    Vinv = _so3_left_jacobian_inv(omega)
    v = torch.einsum("...ij,...j->...i", Vinv, p[..., 4:])
    return torch.cat([omega, v], dim=-1)


def retract(p, xi):
    """Left-multiplicative update: exp(xi) ∘ p  (the GN/LM pose update)."""
    return pose_compose(exp(xi), p)


def pose_distance(a, b):
    """(rotation angle [rad], translation distance) between two poses."""
    d = pose_compose(pose_inv(a), b)
    return (torch.linalg.vector_norm(so3_log(d[..., :4]), dim=-1),
            torch.linalg.vector_norm(d[..., 4:], dim=-1))
