"""TUM RGBD dataset IO (reference dataset loader, SURVEY.md §2.1).

Parses ``rgb.txt`` / ``depth.txt`` / ``groundtruth.txt``, associates rgb and
depth frames by nearest timestamp (<= ``max_dt``), yields
``(timestamp, rgb[H,W,3] u8, depth[H,W] f32 metres)`` and writes TUM-format
trajectories (``timestamp tx ty tz qx qy qz qw``).

Host-side, numpy-only: PNGs decode with the native runtime
(``runtime/native.py``) or with cv2, whichever ``sequence`` is told; never
on the device hot path.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np


def _read_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def read_groundtruth(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps[N], poses[N, 7]) with pose = (qw qx qy qz tx ty tz),
    world-frame T_wc.  TUM files store ``tx ty tz qx qy qz qw``."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            ts.append(v[0])
            tx, ty, tz, qx, qy, qz, qw = v[1:8]
            poses.append([qw, qx, qy, qz, tx, ty, tz])
    return np.array(ts), np.array(poses)


def associate(
    ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02
) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (reference associate())."""
    pairs = []
    used_b: set = set()
    j = 0
    for i, ta in enumerate(ts_a):
        # advance j to the closest tb
        while j + 1 < len(ts_b) and abs(ts_b[j + 1] - ta) <= abs(ts_b[j] - ta):
            j += 1
        best, best_dt = -1, max_dt
        for k in (j - 1, j, j + 1):
            if 0 <= k < len(ts_b) and k not in used_b:
                dt = abs(ts_b[k] - ta)
                if dt <= best_dt:
                    best, best_dt = k, dt
        if best >= 0:
            used_b.add(best)
            pairs.append((i, best))
    return pairs


def _imread_gray_depth(rgb_path: str, depth_path: str, depth_factor: float):
    import cv2  # host-side decode only

    rgb = cv2.imread(rgb_path, cv2.IMREAD_COLOR)[:, :, ::-1].copy()
    d16 = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED)
    depth = d16.astype(np.float32) / depth_factor
    return rgb, depth


def png_size(path: str) -> Tuple[int, int]:
    """(width, height) from a PNG's IHDR chunk, without decoding it."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG")
    return struct.unpack(">II", head[16:24])


def use_native(native: Optional[bool]) -> bool:
    """``native`` as ``sequence`` takes it: None = the native runtime when it
    builds and loads, True = required (raises when unavailable), False =
    cv2."""
    if native is False:
        return False
    from boslam_tpu_torch.runtime import native as native_mod

    ok = native_mod.available()
    if native and not ok:
        raise RuntimeError("native runtime requested but unavailable")
    return ok


def native_frames(rgb_paths, depth_paths, depth_factor: float):
    """(gray f32 [H,W], depth f32 metres) per frame pair from the native
    prefetching decoder; the geometry comes from the first PNG's header."""
    from boslam_tpu_torch.runtime.native import NativeLoader

    w, h = png_size(rgb_paths[0])
    loader = NativeLoader(rgb_paths, depth_paths, w, h, depth_factor)
    try:
        yield from loader
    finally:
        loader.close()


def sequence(
    root: str,
    depth_factor: float = 5000.0,
    max_dt: float = 0.02,
    limit: Optional[int] = None,
    native: Optional[bool] = False,
) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    """Iterate (timestamp, image, depth f32 metres [H,W]).

    ``native`` selects the C++ prefetching decoder (``runtime/native.py``),
    whose workers decode PNGs ahead of the tracking loop: None = auto (use
    it when the library builds and loads), True = required (raises when it
    is unavailable), False = cv2.  The native path yields BT.601 gray f32
    [H,W] images, the cv2 path rgb u8 [H,W,3]; ``SlamSystem.feed`` takes
    both."""
    rgb_list = _read_list(os.path.join(root, "rgb.txt"))
    depth_list = _read_list(os.path.join(root, "depth.txt"))
    ts_r = np.array([t for t, _ in rgb_list])
    ts_d = np.array([t for t, _ in depth_list])
    pairs = associate(ts_r, ts_d, max_dt)
    if limit is not None:
        pairs = pairs[:limit]
    if use_native(native) and pairs:
        decoded = native_frames(
            [os.path.join(root, rgb_list[i][1]) for i, _ in pairs],
            [os.path.join(root, depth_list[j][1]) for _, j in pairs],
            depth_factor,
        )
        for (i, _), (gray, depth) in zip(pairs, decoded):
            yield rgb_list[i][0], gray, depth
        return
    for i, j in pairs:
        rgb, depth = _imread_gray_depth(
            os.path.join(root, rgb_list[i][1]),
            os.path.join(root, depth_list[j][1]),
            depth_factor,
        )
        yield rgb_list[i][0], rgb, depth


def save_trajectory(path: str, timestamps, poses_twc) -> None:
    """Write TUM format: ``timestamp tx ty tz qx qy qz qw`` (T_wc poses [N,7])."""
    poses_twc = np.asarray(poses_twc)
    with open(path, "w") as f:
        for t, p in zip(timestamps, poses_twc):
            qw, qx, qy, qz, tx, ty, tz = p
            f.write(
                f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n"
            )


def load_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    return read_groundtruth(path)


def associate_groundtruth(
    ts: np.ndarray, gt_ts: np.ndarray, gt_poses: np.ndarray, max_dt: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """For each estimate timestamp, the nearest groundtruth pose + valid mask."""
    idx = np.searchsorted(gt_ts, ts)
    idx = np.clip(idx, 1, len(gt_ts) - 1)
    left = idx - 1
    pick = np.where(np.abs(gt_ts[idx] - ts) < np.abs(gt_ts[left] - ts), idx, left)
    mask = np.abs(gt_ts[pick] - ts) <= max_dt
    return gt_poses[pick], mask
