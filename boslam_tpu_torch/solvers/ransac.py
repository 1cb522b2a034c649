"""RANSAC 3D-3D SE3 alignment with the hypotheses as a batch dimension
(``boslam_tpu.solvers.ransac``).

The minimal solver is closed-form Umeyama on 3 depth-backed points.  Every
function takes leading batch dims ([..., N, 3] points, [..., N] masks), so
relocalization's candidates and loop verification's requests run as one
batch, as the reference's ``vmap`` runs them.

Randomness: the reference draws Gumbel noise from a ``jax.random`` key.
Here ``key`` is a ``torch.Generator`` the noise is drawn from, or the noise
itself ([..., H, N] f32), so a test can hand the port JAX's own draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boslam_tpu_torch.geometry import camera as cam_mod
from boslam_tpu_torch.geometry import se3
from boslam_tpu_torch.utils.tensor_ops import top_k

_TINY = torch.finfo(torch.float32).tiny


def gumbel_noise(key, shape, device) -> torch.Tensor:
    """Standard Gumbel noise of ``shape``: drawn from the generator ``key``,
    or ``key`` itself when it is a tensor of that shape."""
    if isinstance(key, torch.Tensor):
        if tuple(key.shape) != tuple(shape):
            raise ValueError(f"Gumbel noise of shape {tuple(key.shape)}, "
                             f"expected {tuple(shape)}")
        return key.to(device=device, dtype=torch.float32)
    u = torch.rand(shape, generator=key, device=device)
    return -torch.log(-torch.log(torch.clamp_min(u, _TINY)))


def _sample_triples(gumbel, weights):
    """[..., H, 3] index triples, sampled ∝ ``weights`` [..., n] without
    replacement per triple (Gumbel top-k over ``gumbel`` [..., H, n]).
    All-zero weights fall back to uniform; fewer than 3 positive weights
    fill the triple with -inf scores, ties to the lowest index."""
    w = torch.where(torch.sum(weights, dim=-1, keepdim=True) > 0, weights,
                    torch.ones_like(weights))
    scores = torch.where(w[..., None, :] > 0,
                         torch.log(w)[..., None, :] + gumbel, -torch.inf)
    return top_k(scores, 3)[1]


def sample_triples(key, weights, n_hypotheses: int):
    """``_sample_triples`` with its noise drawn from ``key`` (see
    ``gumbel_noise``)."""
    g = gumbel_noise(key, weights.shape[:-1] + (n_hypotheses, weights.shape[-1]),
                     weights.device)
    return _sample_triples(g, weights)


def _det3(m):
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def umeyama_fixed_scale(src, dst, w):
    """Weighted closed-form SE3: dst ≈ R src + t.  src/dst [..., N, 3],
    w [..., N] (or [N]).  Returns poses [..., 7]."""
    wsum = torch.clamp_min(torch.sum(w, dim=-1), 1e-9)
    wn = w / wsum[..., None]
    mu_s = torch.sum(wn[..., None] * src, dim=-2)
    mu_d = torch.sum(wn[..., None] * dst, dim=-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = (dc * wn[..., None]).transpose(-1, -2) @ sc
    U, _, Vt = torch.linalg.svd(cov)
    # R does not depend on the SVD's sign choice: d flips the last axis.
    d = torch.sign(_det3(U) * _det3(Vt))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (U * D[..., None, :]) @ Vt
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return se3.make_pose(se3.mat_to_quat(R), t)


def _take(x, idx):
    """``x[..., idx, :]`` per batch: x [..., N, C], idx [..., H, 3] ->
    [..., H, 3, C]."""
    batch = idx.shape[:-2]
    x = x.expand(batch + x.shape[-2:])
    flat = idx.reshape(batch + (-1,))
    out = torch.gather(x, -2, flat[..., None].expand(flat.shape + x.shape[-1:]))
    return out.reshape(idx.shape + x.shape[-1:])


class RansacResult(NamedTuple):
    pose: torch.Tensor       # [..., 7] best T with dst ≈ T(src)
    inliers: torch.Tensor    # [..., N] bool
    n_inliers: torch.Tensor  # [...] i32
    ok: torch.Tensor         # [...] bool (enough inliers found)


def _best_hypothesis(scores, poses):
    """The pose with the most inliers, the first one on a tie (argmax)."""
    best = torch.argmax(scores, dim=-1, keepdim=True)
    return torch.gather(poses, -2, best[..., None].expand(best.shape + (7,)))[..., 0, :]


def ransac_pnp(cfg, pts_w, uv, xyz_cam, has_depth, mask, key,
               n_hypotheses: int = 128, threshold: float = None,
               min_inliers: int = 12) -> RansacResult:
    """RANSAC PnP: 2D-3D pose with REPROJECTION-scored consensus.

    Hypotheses come from minimal 3-point 3D-3D alignments on depth-backed
    correspondences; the consensus set is scored by pixel reprojection of
    all matched keypoints, with the inlier bound
    ``tracker.ransac_threshold`` pixels.

    Args:
      pts_w: [..., N, 3] matched world points; uv: [N, 2] observed pixels;
      xyz_cam: [N, 3] camera-frame backprojections (0 where no depth);
      has_depth: [N] bool; mask: [..., N] bool valid correspondences;
      key: a ``torch.Generator`` or Gumbel noise [..., H, N].
    """
    px = cfg.tracker.ransac_threshold if threshold is None else threshold
    m3 = (mask & has_depth).to(torch.float32)
    idx = sample_triples(key, m3, n_hypotheses)              # [..., H, 3]

    def score(pose, pts):
        xc = se3.pose_apply(pose[..., None, :], pts)
        uv_pred = cam_mod.project(cfg.camera, xc)
        err = torch.linalg.vector_norm(uv_pred - uv, dim=-1)
        return (err < px) & (xc[..., 2] > 1e-3)

    poses = umeyama_fixed_scale(_take(pts_w, idx), _take(xyz_cam, idx),
                                torch.ones(3, device=pts_w.device))  # [..., H, 7]
    hyp = score(poses, pts_w[..., None, :, :]) & mask[..., None, :]
    pose = _best_hypothesis(torch.sum(hyp, dim=-1), poses)
    # Refine on the 3D-capable subset of the winning 2D consensus.
    for _ in range(2):
        w = (score(pose, pts_w) & mask & has_depth).to(torch.float32)
        pose = umeyama_fixed_scale(pts_w, xyz_cam, w + 1e-9)
    inliers = score(pose, pts_w) & mask
    n_inl = torch.sum(inliers, dim=-1).to(torch.int32)
    return RansacResult(pose, inliers, n_inl, n_inl >= min_inliers)


def ransac_se3(src, dst, mask, key, n_hypotheses: int = 128,
               threshold=0.1, min_inliers: int = 12) -> RansacResult:
    """Robust SE3 from 3D-3D correspondences.

    Args:
      src, dst: [..., N, 3] corresponding points (masked).
      mask: [..., N] bool valid correspondences.
      key: a ``torch.Generator`` or Gumbel noise [..., H, N].
      threshold: inlier 3D distance bound (metres), a float or [..., N]
        per-correspondence radii.

    The winner is refined by two weighted Umeyama fits on its inliers.
    """
    idx = sample_triples(key, mask.to(torch.float32), n_hypotheses)
    thr = torch.as_tensor(threshold, dtype=src.dtype, device=src.device)

    def inl(pose, s, d, t):
        err = torch.linalg.vector_norm(se3.pose_apply(pose[..., None, :], s) - d,
                                       dim=-1)
        return err < t

    poses = umeyama_fixed_scale(_take(src, idx), _take(dst, idx),
                                torch.ones(3, device=src.device))  # [..., H, 7]
    thr_h = thr[..., None, :] if thr.dim() > 0 else thr
    hyp = inl(poses, src[..., None, :, :], dst[..., None, :, :], thr_h) \
        & mask[..., None, :]
    pose = _best_hypothesis(torch.sum(hyp, dim=-1), poses)
    for _ in range(2):
        w = (inl(pose, src, dst, thr) & mask).to(torch.float32)
        pose = umeyama_fixed_scale(src, dst, w + 1e-9)
    inliers = inl(pose, src, dst, thr) & mask
    n_inl = torch.sum(inliers, dim=-1).to(torch.int32)
    return RansacResult(pose, inliers, n_inl, n_inl >= min_inliers)
