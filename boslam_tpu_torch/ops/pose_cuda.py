"""Motion-only bundle adjustment as one launch of a hand-written CUDA kernel.

``pose_gn`` runs ``solvers.pose_opt.optimize_pose_plain`` (robust
Gauss-Newton on one SE3 pose with chi2 re-gating) for CUDA tensors as ONE
launch of ``csrc/pose_gn.cu``: every round and step stays on the card, one
block per pose of the flattened leading dims.  ``solvers.pose_opt.
optimize_pose`` calls it for a CUDA tensor and takes the plain version for a
CPU tensor; there is no other route.  ``LAUNCHES["pose_gn"]`` counts launches.

The kernel reads every input as [B, N, ...] rows with one batch stride per
input, 0 where a caller broadcasts it over the batch (relocalization's frame
keypoints against [R, N] candidates): nothing is copied but an input whose
rows are not contiguous.  The launch's arguments travel in one struct that
the C entry hands to the kernel by value.
"""

from __future__ import annotations

import ctypes

import torch

from boslam_tpu_torch.ops.build import LAUNCHES, check_launch, kernel_fn

THREADS, MAX_EPT = 256, 16          # csrc/pose_gn.cu
MAX_EDGES = THREADS * MAX_EPT       # edges a pose may have


# Mirrors PoseGnArgs in csrc/pose_gn.cu.
class _PoseGnArgs(ctypes.Structure):
    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "pose0", "pts", "uv", "depth", "has_depth", "obs_mask", "octave",
            "inliers0", "pose", "inliers", "n_inliers", "chi2")]
        + [(name, ctypes.c_longlong) for name in (
            "s_pose0", "s_pts", "s_uv", "s_depth", "s_has_depth",
            "s_obs_mask", "s_octave", "s_inliers0")]
        + [(name, ctypes.c_int) for name in ("b", "n", "rounds", "iters")]
        + [(name, ctypes.c_float) for name in (
            "fx", "fy", "cx", "cy", "depth_weight", "huber_delta", "chi2_2d",
            "chi2_3d", "scale_factor")])


def _rows_contiguous(t: torch.Tensor, k: int) -> bool:
    """Whether the last ``k`` dims of ``t`` are laid out row-major dense."""
    want = 1
    for size, stride in zip(reversed(t.shape[t.dim() - k:]),
                            reversed(t.stride()[t.dim() - k:])):
        if size > 1 and stride != want:
            return False
        want *= size
    return True


def operand(t: torch.Tensor, tail: tuple, batch: tuple):
    """(``t`` as [B, *tail] rows, batch stride in elements) for the kernel:
    the leading dims broadcast to ``batch`` and flattened, a stride of 0
    where ``t`` is broadcast; a copy only where ``t``'s rows are not dense
    or its batch dims cannot be flattened to one stride."""
    k = len(tail)
    if not _rows_contiguous(t, k):
        t = t.contiguous()
    t = t.expand(batch + tail)
    if len(batch) == 0:
        return t, 0
    if len(batch) > 1:
        t = t.reshape((-1,) + tail)
    return t, t.stride(0)


def _check(name: str, t: torch.Tensor, dtype, tail: tuple, dev) -> None:
    if t.dtype != dtype:
        raise ValueError(f"pose_gn: {name} must be {dtype}, got {t.dtype}")
    if t.dim() < len(tail) or tuple(t.shape[t.dim() - len(tail):]) != tail:
        raise ValueError(f"pose_gn: {name} must end in {tail}, got "
                         f"{tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"pose_gn: {name} is on {t.device}, pts_w on {dev}")


def pose_gn(cfg, pose0, pts_w, uv_obs, depth_obs, has_depth, obs_mask,
            octave=None, inliers0=None):
    """``optimize_pose_plain``'s result as ONE launch of the ``pose_gn``
    kernel, for CUDA tensors: (pose [..., 7], inliers [..., N] bool,
    n_inliers [...] int32, chi2 [...] float32 final robust cost).

    Takes ``optimize_pose``'s arguments: float32 ``pose0`` [..., 7],
    ``pts_w`` [..., N, 3], ``uv_obs`` [..., N, 2], ``depth_obs`` [..., N];
    bool ``has_depth``, ``obs_mask`` and optional ``inliers0`` [..., N];
    optional int32 ``octave`` [..., N]; leading dims broadcast against each
    other.  Raises ValueError on another dtype, shape or device, or on more
    than MAX_EDGES edges; does not synchronise."""
    dev = pts_w.device
    if pts_w.dim() < 2:
        raise ValueError(f"pose_gn: pts_w must be [..., N, 3], got "
                         f"{tuple(pts_w.shape)}")
    n = pts_w.shape[-2]
    f32, b8 = torch.float32, torch.bool
    # (argument, field of the kernel's struct, tensor, dtype, row shape)
    inputs = [("pose0", "pose0", pose0, f32, (7,)),
              ("pts_w", "pts", pts_w, f32, (n, 3)),
              ("uv_obs", "uv", uv_obs, f32, (n, 2)),
              ("depth_obs", "depth", depth_obs, f32, (n,)),
              ("has_depth", "has_depth", has_depth, b8, (n,)),
              ("obs_mask", "obs_mask", obs_mask, b8, (n,)),
              ("octave", "octave", octave, torch.int32, (n,)),
              ("inliers0", "inliers0", inliers0, b8, (n,))]
    inputs = [x for x in inputs if x[2] is not None]
    for name, _, t, dtype, tail in inputs:
        _check(name, t, dtype, tail, dev)
    try:
        batch = tuple(torch.broadcast_shapes(
            *(t.shape[:t.dim() - len(tail)] for _, _, t, _, tail in inputs)))
    except RuntimeError as e:
        raise ValueError(f"pose_gn: leading dims do not broadcast: {e}") from e
    if n > MAX_EDGES:
        raise ValueError(f"pose_gn: {n} edges, the kernel takes at most "
                         f"{MAX_EDGES}")
    tk = cfg.tracker
    if tk.ba_rounds < 0 or tk.ba_iters < 1:
        raise ValueError(f"pose_gn: ba_rounds {tk.ba_rounds} and ba_iters "
                         f"{tk.ba_iters}; the kernel needs >= 0 and >= 1")
    if dev.type != "cuda":
        raise ValueError(f"pose_gn: needs CUDA tensors, got {dev}")
    pose = torch.empty(batch + (7,), dtype=f32, device=dev)
    inliers = torch.empty(batch + (n,), dtype=b8, device=dev)
    n_inliers = torch.empty(batch, dtype=torch.int32, device=dev)
    chi2 = torch.empty(batch, dtype=f32, device=dev)
    n_poses = pose.numel() // 7
    if n_poses == 0:
        return pose, inliers, n_inliers, chi2
    cam = cfg.camera
    args = _PoseGnArgs(
        pose=pose.data_ptr(), inliers=inliers.data_ptr(),
        n_inliers=n_inliers.data_ptr(), chi2=chi2.data_ptr(), b=n_poses, n=n,
        rounds=tk.ba_rounds, iters=tk.ba_iters, fx=cam.fx, fy=cam.fy,
        cx=cam.cx, cy=cam.cy, depth_weight=tk.depth_weight,
        huber_delta=tk.huber_delta, chi2_2d=tk.chi2_2d, chi2_3d=tk.chi2_3d,
        scale_factor=cfg.orb.scale_factor)
    keep = []  # the operands, alive until the launch is queued
    for _, field, t, _, tail in inputs:
        rows, stride = operand(t, tail, batch)
        keep.append(rows)
        setattr(args, field, rows.data_ptr())
        setattr(args, "s_" + field, stride)
    fn = kernel_fn("pose_gn")
    with torch.cuda.device(dev):
        err = fn(ctypes.addressof(args),
                 torch.cuda.current_stream(dev).cuda_stream)
    check_launch("pose_gn", err)
    LAUNCHES["pose_gn"] += 1
    return pose, inliers, n_inliers, chi2
