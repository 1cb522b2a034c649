"""SE(3) on [..., 7] poses (qw qx qy qz tx ty tz) and the absolute
trajectory error, in plain PyTorch of any float dtype.

The formulas of ``boslam_tpu_torch/geometry/se3.py`` (``quat_mul``,
``quat_to_mat``, ``so3_exp_quat``, ``_so3_left_jacobian``, ``exp``,
``pose_compose``, ``retract``) and ``boslam_tpu_torch/geometry/align.py``
(``umeyama``, ``ate_rmse``), frozen at commit bd2752c and written again
here, with the inverse and the logarithm of a pose for the essential
graph's residual (``reference.pose_graph``); nothing imports the port.
Rotations of points go through matrix products (``mm``), whose operands
``tf32=True`` rounds to TF32 (10 bits of mantissa, as the tensor cores read
float32): the reference computed in the precision below the
configuration's float32, whatever shapes cuBLAS would send to its tensor
cores.
"""

from __future__ import annotations

import torch


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def quat_normalize(q):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def to_tf32(x):
    """float32 -> the nearest TF32 value (ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def mm(a, b, tf32: bool = False):
    """A matrix product, its operands rounded to TF32 with ``tf32``."""
    if tf32:
        a, b = to_tf32(a), to_tf32(b)
    return torch.matmul(a, b)


def rotate(R, x, tf32: bool = False):
    """R [..., 3, 3] applied to x [..., 3] as a batched matrix product."""
    return mm(R, x[..., None], tf32)[..., 0]


def hat(v):
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       -1).reshape(v.shape[:-1] + (3, 3))


def exp(xi, tf32: bool = False):
    """Twist (omega, v) -> pose: rotation by the exponential map,
    translation V(omega) v."""
    omega, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(omega * omega, -1, keepdim=True)
    small = theta2 < 1e-12
    t2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(t2)
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(0.5 * theta) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(0.5 * theta))
    q = quat_normalize(torch.cat([w, k * omega], -1))
    W = hat(omega)
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (t2 * theta))
    Wv = rotate(W, v, tf32)
    t = v + a * Wv + b * rotate(W, Wv, tf32)
    return torch.cat([q, t], -1)


def pose_compose(a, b, tf32: bool = False):
    """(a o b)(x) = a(b(x))."""
    q = quat_normalize(quat_mul(a[..., :4], b[..., :4]))
    t = rotate(quat_to_mat(a[..., :4]), b[..., 4:], tf32) + a[..., 4:]
    return torch.cat([q, t], -1)


def pose_inv(p):
    """The inverse pose: conjugate rotation, translation -R^T t."""
    q = p[..., :4] * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=p.dtype,
                                  device=p.device)
    return torch.cat([q, -rotate(quat_to_mat(q), p[..., 4:])], -1)


def log(p):
    """Pose -> twist (omega, v), the inverse of ``exp``: the rotation
    vector of the quaternion (taken with w >= 0), and v = V(omega)^-1 t."""
    q = p[..., :4] * torch.where(p[..., :1] < 0, -1.0, 1.0)
    w, u = q[..., :1], q[..., 1:]
    s2 = torch.sum(u * u, -1, keepdim=True)
    small = s2 < 1e-24
    s = torch.sqrt(torch.where(small, 1.0, s2))
    theta = 2.0 * torch.atan2(s, w)
    omega = torch.where(small, 2.0 / w, theta / s) * u
    t2 = torch.sum(omega * omega, -1)[..., None, None]
    tiny = t2 < 1e-12
    th = torch.sqrt(torch.where(tiny, 1.0, t2))
    # V^-1 = I - W / 2 + (1 / th^2 - (1 + cos th) / (2 th sin th)) W^2
    c = torch.where(tiny, 1.0 / 12.0 + t2 / 720.0,
                    1.0 / th ** 2 - (1.0 + torch.cos(th))
                    / (2.0 * th * torch.sin(th)))
    W = hat(omega)
    v = p[..., 4:]
    Wv = rotate(W, v)
    return torch.cat([omega, v - 0.5 * Wv + c[..., 0] * rotate(W, Wv)], -1)


def retract(p, xi, tf32: bool = False):
    """The left-multiplied update exp(xi) o p."""
    return pose_compose(exp(xi, tf32), p, tf32)


def ate_rmse(est_xyz, gt_xyz):
    """(RMSE of the residuals, R [3, 3], t [3]) after the rigid (SE(3))
    least-squares alignment of ``est_xyz`` onto ``gt_xyz`` ([N, 3] each)."""
    est = torch.as_tensor(est_xyz, dtype=torch.float64)
    gt = torch.as_tensor(gt_xyz, dtype=torch.float64)
    mu_s, mu_d = est.mean(0), gt.mean(0)
    cov = (gt - mu_d).T @ (est - mu_s) / est.shape[0]
    U, _, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = U @ D @ Vt
    t = mu_d - R @ mu_s
    aligned = est @ R.T + t
    return float(torch.sqrt(torch.mean(torch.sum((aligned - gt) ** 2, -1)))), R, t
