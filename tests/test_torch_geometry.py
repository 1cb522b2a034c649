"""Geometry parity of the port: se3 / camera / align against the JAX
package on the same numpy inputs, at rtol 1e-5 (float32; atol 1e-6 for
values near zero)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import _torch_parity as tp
from boslam_tpu.geometry import align as j_align
from boslam_tpu.geometry import camera as j_cam
from boslam_tpu.geometry import se3 as j_se3
from boslam_tpu_torch.geometry import align, camera, se3

RTOL, ATOL = 1e-5, 1e-6


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _poses(rng, n):
    xi = rng.normal(0, 0.6, (n, 6)).astype(np.float32)
    return np.array(j_se3.exp(jnp.asarray(xi))), xi


@pytest.mark.parametrize("name", [
    "quat_mul", "quat_rotate", "quat_to_mat", "pose_compose", "pose_inv",
    "pose_apply", "exp", "log", "retract", "so3_log", "hat", "mat_to_quat",
    "pose_distance", "rotation", "translation", "pose_to_mat", "mat_to_pose",
])
def test_se3_matches_jax(rng, name):
    p, xi = _poses(rng, 64)
    q, _ = _poses(rng, 64)
    x = rng.normal(0, 2.0, (64, 3)).astype(np.float32)
    small = (xi * 1e-7).astype(np.float32)  # Taylor branches
    args = {
        "quat_mul": [(p[:, :4], q[:, :4])],
        "quat_rotate": [(p[:, :4], x)],
        "quat_to_mat": [(p[:, :4],)],
        "pose_compose": [(p, q)],
        "pose_inv": [(p,)],
        "pose_apply": [(p, x)],
        "exp": [(xi,), (small,)],
        "log": [(p,)],
        "retract": [(p, xi * 0.1)],
        "so3_log": [(p[:, :4],)],
        "hat": [(x,)],
        "mat_to_quat": [(np.array(j_se3.quat_to_mat(jnp.asarray(p[:, :4]))),)],
        "pose_distance": [(p, q)],
        "rotation": [(p,)],
        "translation": [(p,)],
        "pose_to_mat": [(p,)],
        "mat_to_pose": [(np.array(j_se3.pose_to_mat(jnp.asarray(p))),)],
    }[name]
    for a in args:
        ref = getattr(j_se3, name)(*map(jnp.asarray, a))
        got = getattr(se3, name)(*map(torch.from_numpy, a))
        for g, r in zip(got, ref) if isinstance(ref, tuple) else [(got, ref)]:
            _close(g, r)


@pytest.mark.parametrize("shape", [(), (5,), (2, 3)])
def test_quat_identity_matches_jax(shape):
    got = se3.quat_identity(shape)
    assert got.dtype == torch.float32 and got.shape == shape + (4,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_se3.quat_identity(shape)))


def test_intrinsics_matches_jax():
    cfg_j, cfg_t = tp.configs(tp.E2E)
    got = camera.intrinsics(cfg_t.camera)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_cam.intrinsics(cfg_j.camera)))


def test_camera_matches_jax(rng):
    cfg_j, cfg_t = tp.configs(tp.E2E)
    xc = np.concatenate([rng.normal(0, 1, (100, 2)), rng.uniform(0.2, 5, (100, 1))],
                        1).astype(np.float32)
    uv = rng.uniform(0, 320, (100, 2)).astype(np.float32)
    z = rng.uniform(0, 9, 100).astype(np.float32)
    _close(camera.project(cfg_t.camera, torch.from_numpy(xc)),
           j_cam.project(cfg_j.camera, jnp.asarray(xc)))
    _close(camera.backproject(cfg_t.camera, torch.from_numpy(uv), torch.from_numpy(z)),
           j_cam.backproject(cfg_j.camera, jnp.asarray(uv), jnp.asarray(z)))
    _close(camera.project_jacobian(cfg_t.camera, torch.from_numpy(xc)),
           j_cam.project_jacobian(cfg_j.camera, jnp.asarray(xc)))
    np.testing.assert_array_equal(
        camera.in_image(cfg_t.camera, torch.from_numpy(uv), 1.0).numpy(),
        np.asarray(j_cam.in_image(cfg_j.camera, jnp.asarray(uv), 1.0)))
    np.testing.assert_array_equal(
        camera.valid_depth(cfg_t.camera, torch.from_numpy(z)).numpy(),
        np.asarray(j_cam.valid_depth(cfg_j.camera, jnp.asarray(z))))


def test_align_matches_jax(rng):
    est = rng.normal(0, 1, (50, 3)).astype(np.float32)
    p, _ = _poses(rng, 1)
    gt = (np.array(j_se3.pose_apply(jnp.asarray(p[0]), jnp.asarray(est)))
          + rng.normal(0, 0.01, (50, 3))).astype(np.float32)
    w = (rng.random(50) > 0.2).astype(np.float32)
    for with_scale in (False, True):
        r_ref, al_ref = j_align.ate_rmse(jnp.asarray(est), jnp.asarray(gt),
                                         jnp.asarray(w), with_scale)
        r, al = align.ate_rmse(torch.from_numpy(est), torch.from_numpy(gt),
                               torch.from_numpy(w), with_scale)
        _close(r, r_ref)
        _close(al, al_ref)
    poses_a, _ = _poses(rng, 20)
    poses_b, _ = _poses(rng, 20)
    for g, r in zip(align.rpe(torch.from_numpy(poses_a), torch.from_numpy(poses_b)),
                    j_align.rpe(jnp.asarray(poses_a), jnp.asarray(poses_b))):
        _close(g, r)
