"""Motion-only BA problems at the shapes of ``optimize_pose``'s three callers,
for the CPU and card tests of the ``pose_gn`` kernel.  Made with numpy from
a seed; imports neither JAX nor the JAX package.

* ``track``: tracking's passes, B = 1 (pose [7], edges [N]);
* ``reloc``: relocalization's candidates, pose [R, 7] and points [R, N, 3]
  against the frame's keypoints [N] (broadcast), with RANSAC's inliers;
  ``reloc1000`` the same at ORB-SLAM2's 1000 features;
* ``verify``: loop verification's batch, every input per request
  ([B, N, ...], the requests' own keypoints), with RANSAC's inliers.

Edge cases (``track`` shapes): ``no_mask`` (every mask false), ``few_edges``
(two observed edges), ``behind`` (a fifth of the points behind the camera),
``no_depth`` (no depth anywhere), ``nan_point`` (one observed point is NaN:
the first round's factor fails on every step, so its steps are zero, until
the re-gating drops the edge).
"""

import numpy as np
import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.geometry import se3

CASES = {
    # name: (kind, N, leading dim, edge case)
    "track512": ("track", 512, None, None),
    "track1024": ("track", 1024, None, None),
    "reloc": ("reloc", 512, 4, None),
    "reloc1000": ("reloc", 1000, 4, None),
    "verify": ("verify", 512, 3, None),
    "no_mask": ("track", 512, None, "no_mask"),
    "few_edges": ("track", 512, None, "few_edges"),
    "behind": ("track", 512, None, "behind"),
    "no_depth": ("track", 512, None, "no_depth"),
    "nan_point": ("track", 512, None, "nan_point"),
}


def _pose(rng, scale):
    q = np.array([1.0, *rng.normal(0.0, scale, 3)])
    return np.concatenate([q / np.linalg.norm(q),
                           rng.normal(0.0, 4 * scale, 3)]).astype(np.float32)


def _views(rng, cam, n, behind):
    """Camera-frame points in view, observed with 0.7 px noise, a tenth of
    them outliers by up to 40 px; depth with 1 cm noise."""
    z = rng.uniform(1.0, 6.0, n)
    if behind:
        back = rng.random(n) < 0.2
        z[back] = rng.uniform(-2.0, 1e-3, int(back.sum()))
    u = rng.uniform(0.0, cam.width, n)
    v = rng.uniform(0.0, cam.height, n)
    xc = np.stack([(u - cam.cx) / cam.fx * np.abs(z),
                   (v - cam.cy) / cam.fy * np.abs(z), z], 1)
    uv = np.stack([u, v], 1) + rng.normal(0.0, 0.7, (n, 2))
    out = rng.random(n) < 0.1
    uv[out] += rng.uniform(-40.0, 40.0, (int(out.sum()), 2))
    depth = z + rng.normal(0.0, 0.01, n)
    return xc, uv, depth


def _world(pose_cw, xc):
    inv = se3.pose_inv(torch.from_numpy(pose_cw))
    return se3.pose_apply(inv, torch.from_numpy(xc).float()).numpy()


def problem(name: str, seed: int, device="cpu"):
    """(cfg, args, kwargs) of ``optimize_pose(cfg, *args, **kwargs)`` for
    case ``name``, as tensors on ``device``."""
    kind, n, lead, edge = CASES[name]
    rng = np.random.default_rng(seed)
    cfg = SlamConfig()
    cam = cfg.camera
    rows = 1 if lead is None else lead
    frame_xc, frame_uv, frame_depth = _views(rng, cam, n, edge == "behind")
    pose0, pts, uv, depth, hd, obs, oct_, inl0 = ([] for _ in range(8))
    for _ in range(rows):
        if kind == "verify":
            xc, uvr, dr = _views(rng, cam, n, False)
        else:
            xc, uvr, dr = frame_xc, frame_uv, frame_depth
        true = _pose(rng, 0.1)
        pts.append(_world(true, xc))
        if edge == "nan_point":
            pts[-1][0] = np.nan
        pose0.append(se3.retract(torch.from_numpy(true), torch.from_numpy(
            rng.normal(0.0, 0.02, 6).astype(np.float32))).numpy())
        uv.append(uvr)
        depth.append(dr)
        o = rng.random(n) < 0.95
        o[0] |= edge == "nan_point"
        if edge == "no_mask":
            o[:] = False
        elif edge == "few_edges":
            o[:] = False
            o[rng.choice(n, 2, replace=False)] = True
        obs.append(o)
        h = o & (rng.random(n) < 0.7) & (edge != "no_depth")
        hd.append(h)
        oct_.append(rng.integers(0, cfg.orb.n_levels, n))
        inl0.append(o & (rng.random(n) < 0.9))

    def t(xs, dtype, shared=False):
        a = np.asarray(xs[0] if shared else xs)
        if lead is None and not shared:
            a = a[0]
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    f32, b8 = torch.float32, torch.bool
    if kind == "reloc":  # the frame's keypoints against R candidates
        args = (t(pose0, f32), t(pts, f32), t(uv, f32, True),
                t(depth, f32, True), t(hd, b8), t(obs, b8))
        kwargs = dict(octave=t(oct_, torch.int32, True), inliers0=t(inl0, b8))
    else:
        args = (t(pose0, f32), t(pts, f32), t(uv, f32), t(depth, f32),
                t(hd, b8), t(obs, b8))
        kwargs = dict(octave=t(oct_, torch.int32))
        if kind == "verify":
            kwargs["inliers0"] = t(inl0, b8)
    return cfg, args, kwargs
