"""RANSAC parity of the port (``solvers/ransac.py``) against the JAX package.

Random streams cannot be reproduced across frameworks, so each test draws
JAX's own Gumbel noise (``jax.random.gumbel`` with the key the JAX function
receives) and hands it to the port's pure sampler.

Tolerances: sampled triples, inlier sets, inlier counts and ``ok`` exact;
poses within 1e-4 (float32 SVD and sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from boslam_tpu.solvers import ransac as j_ransac
from boslam_tpu_torch.solvers import ransac

POSE_ATOL = 1e-4
H = 128


def _noise(key, n, h=H):
    return np.array(jax.random.gumbel(key, (h, n)))


@pytest.mark.parametrize("n_pos", [40, 2, 0])
def test_sample_triples_with_jax_noise(n_pos):
    """Mixed weights, fewer than 3 positive (-inf ties) and none (the
    uniform fallback) draw the same triples as JAX."""
    n = 64
    rng = np.random.default_rng(n_pos)
    w = np.zeros(n, np.float32)
    w[rng.choice(n, n_pos, replace=False)] = 1.0
    key = jax.random.key(7)
    ref = np.asarray(j_ransac._sample_triples(key, jnp.asarray(w), H))
    got = ransac._sample_triples(torch.from_numpy(_noise(key, n)), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sample_triples_draws_distinct_positive_indices():
    gen = torch.Generator().manual_seed(0)
    w = torch.zeros(50)
    w[::3] = 1.0
    tri = ransac.sample_triples(gen, w, H)
    assert tri.shape == (H, 3)
    assert bool(torch.all(w[tri] > 0))
    s = torch.sort(tri, dim=-1).values
    assert bool(torch.all(s[:, 1:] != s[:, :-1]))


def _rigid(rng):
    q = rng.normal(size=4)
    q = (q / np.linalg.norm(q)).astype(np.float32)
    q[0] = abs(q[0]) + 2.0  # a moderate rotation
    q /= np.linalg.norm(q)
    return np.concatenate([q, rng.normal(scale=0.3, size=3)]).astype(np.float32)


def _apply_np(pose, x):
    from boslam_tpu_torch.geometry import se3
    return se3.pose_apply(torch.from_numpy(pose), torch.from_numpy(x)).numpy()


def test_umeyama_fixed_scale_matches_jax():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(3, 40, 3)).astype(np.float32)
    dst = np.stack([_apply_np(_rigid(rng), s) for s in src])
    dst = dst + rng.normal(scale=0.01, size=dst.shape).astype(np.float32)
    w = rng.random((3, 40)).astype(np.float32)
    got = ransac.umeyama_fixed_scale(torch.from_numpy(src), torch.from_numpy(dst),
                                     torch.from_numpy(w)).numpy()
    for b in range(3):
        ref = np.asarray(j_ransac.umeyama_fixed_scale(
            jnp.asarray(src[b]), jnp.asarray(dst[b]), jnp.asarray(w[b])))
        np.testing.assert_allclose(got[b], ref, atol=POSE_ATOL)


def _pnp_problem(seed, n=160):
    """Camera-frame points in front of the camera, the world pose, 25%
    gross outliers, 80% with depth."""
    cfg_j, cfg_t = tp.configs(tp.SMALL)
    rng = np.random.default_rng(seed)
    xc = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                   rng.uniform(1.0, 4.0, n)], -1).astype(np.float32)
    t_cw = _rigid(rng)
    from boslam_tpu_torch.geometry import camera, se3

    pts_w = se3.pose_apply(se3.pose_inv(torch.from_numpy(t_cw)), torch.from_numpy(xc))
    uv = camera.project(cfg_t.camera, torch.from_numpy(xc)).numpy()
    pts_w = pts_w.numpy()
    out = rng.random(n) < 0.25
    pts_w[out] += rng.normal(scale=0.5, size=(out.sum(), 3)).astype(np.float32)
    has_depth = rng.random(n) < 0.8
    xyz = np.where(has_depth[:, None], xc, 0.0).astype(np.float32)
    mask = rng.random(n) < 0.95
    return cfg_j, cfg_t, pts_w, uv, xyz, has_depth, mask


def _close_result(got, ref):
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers)
    assert bool(got.ok) == bool(ref.ok)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=POSE_ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_pnp_with_injected_noise(seed):
    cfg_j, cfg_t, pts_w, uv, xyz, has_depth, mask = _pnp_problem(seed)
    key = jax.random.key(seed)
    ref = j_ransac.ransac_pnp(cfg_j, jnp.asarray(pts_w), jnp.asarray(uv),
                              jnp.asarray(xyz), jnp.asarray(has_depth),
                              jnp.asarray(mask), key, H)
    got = ransac.ransac_pnp(cfg_t, torch.from_numpy(pts_w), torch.from_numpy(uv),
                            torch.from_numpy(xyz), torch.from_numpy(has_depth),
                            torch.from_numpy(mask),
                            torch.from_numpy(_noise(key, len(mask))), H)
    assert int(ref.n_inliers) > 60
    _close_result(got, ref)


def test_ransac_pnp_batch_is_per_candidate():
    """A [R, N] batch gives each row what the unbatched call gives it."""
    probs = [_pnp_problem(s) for s in (2, 3)]
    cfg_j, cfg_t = probs[0][:2]
    uv, xyz, has_depth = probs[0][3:6]
    pts = np.stack([probs[0][2], probs[1][2]])
    masks = np.stack([probs[0][6], probs[1][6]])
    keys = jax.random.split(jax.random.key(5), 2)
    noise = np.stack([_noise(k, masks.shape[1]) for k in keys])
    got = ransac.ransac_pnp(cfg_t, torch.from_numpy(pts), torch.from_numpy(uv),
                            torch.from_numpy(xyz), torch.from_numpy(has_depth),
                            torch.from_numpy(masks), torch.from_numpy(noise), H)
    for r in range(2):
        ref = j_ransac.ransac_pnp(cfg_j, jnp.asarray(pts[r]), jnp.asarray(uv),
                                  jnp.asarray(xyz), jnp.asarray(has_depth),
                                  jnp.asarray(masks[r]), keys[r], H)
        _close_result(ransac.RansacResult(*(x[r] for x in got)), ref)


@pytest.mark.parametrize("per_point", [False, True])
def test_ransac_se3_with_injected_noise(per_point):
    rng = np.random.default_rng(11)
    n = 200
    src = rng.normal(size=(n, 3)).astype(np.float32) + np.float32([0, 0, 3])
    dst = _apply_np(_rigid(rng), src)
    dst = dst + rng.normal(scale=0.01, size=dst.shape).astype(np.float32)
    out = rng.random(n) < 0.3
    dst[out] += rng.normal(scale=0.8, size=(out.sum(), 3)).astype(np.float32)
    mask = rng.random(n) < 0.9
    thr = (np.maximum(0.05, 0.02 * src[:, 2]).astype(np.float32) if per_point
           else 0.05)
    key = jax.random.key(3)
    ref = j_ransac.ransac_se3(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
                              key, H, jnp.asarray(thr), 40)
    got = ransac.ransac_se3(torch.from_numpy(src), torch.from_numpy(dst),
                            torch.from_numpy(mask), torch.from_numpy(_noise(key, n)),
                            H, torch.from_numpy(np.asarray(thr)) if per_point else thr,
                            40)
    assert int(ref.n_inliers) > 100
    _close_result(got, ref)


def test_noise_shape_is_checked():
    with pytest.raises(ValueError):
        ransac.sample_triples(torch.zeros((H, 9)), torch.ones(10), H)
