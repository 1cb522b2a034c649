"""ICL-NUIM RGBD dataset IO (``boslam_tpu.io.icl_nuim``).

Two on-disk layouts of the ICL-NUIM living-room / office sequences:

1. **TUM-compatible export**: ``rgb.txt`` / ``depth.txt`` association lists,
   16-bit depth PNGs at factor 5000 and a ``*.gt.freiburg`` (or
   ``groundtruth.txt``) trajectory, loaded through ``io/tum.py``.
2. **Raw export**: ``rgb/<n>.png`` + ``depth/<n>.png`` numbered frames with
   no timestamp files; timestamps are synthesized at 30 Hz.

Camera: ``config.ICL_NUIM`` (640x480, fx=481.20 fy=480.00 cx=319.50
cy=239.50).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Iterator, Optional, Tuple

import numpy as np

from boslam_tpu_torch.io import tum

ICL_DEPTH_FACTOR = 5000.0


def groundtruth_path(root: str) -> Optional[str]:
    """The groundtruth trajectory file of an ICL-NUIM sequence, or None."""
    cands = sorted(glob.glob(os.path.join(root, "*.gt.freiburg")))
    if cands:
        return cands[0]
    p = os.path.join(root, "groundtruth.txt")
    return p if os.path.exists(p) else None


def read_groundtruth(root_or_file: str):
    """(timestamps[N], poses_twc[N, 7]) in the engine's (qw qx qy qz t)
    order; ``*.gt.freiburg`` rows are TUM-format."""
    path = root_or_file
    if os.path.isdir(root_or_file):
        path = groundtruth_path(root_or_file)
        if path is None:
            raise OSError(f"no groundtruth in {root_or_file}")
    return tum.read_groundtruth(path)


def _numbered(dirpath: str):
    out = []
    for p in glob.glob(os.path.join(dirpath, "*.png")):
        m = re.search(r"(\d+)\.png$", p)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def sequence(
    root: str,
    depth_factor: float = ICL_DEPTH_FACTOR,
    limit: Optional[int] = None,
    fps: float = 30.0,
    native: Optional[bool] = False,
) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    """Iterate (timestamp, image, depth f32 metres [H,W]); ``native`` as in
    ``tum.sequence`` (the native path yields gray f32 images, cv2 rgb u8)."""
    if os.path.exists(os.path.join(root, "rgb.txt")):
        yield from tum.sequence(root, depth_factor, limit=limit, native=native)
        return
    rgbs = _numbered(os.path.join(root, "rgb"))
    depths = dict(_numbered(os.path.join(root, "depth")))
    if not rgbs:
        raise OSError(
            f"{root}: neither rgb.txt (TUM-compatible) nor rgb/*.png (raw)"
        )
    paired = [(idx, p, depths[idx]) for idx, p in rgbs if idx in depths]
    if limit is not None:
        paired = paired[:limit]
    if tum.use_native(native) and paired:
        decoded = tum.native_frames([p for _, p, _ in paired],
                                    [d for _, _, d in paired], depth_factor)
        for (idx, _, _), (gray, depth) in zip(paired, decoded):
            yield idx / fps, gray, depth
        return
    import cv2  # host-side decode only

    for idx, rgb_path, depth_path in paired:
        rgb = cv2.imread(rgb_path, cv2.IMREAD_COLOR)[:, :, ::-1].copy()
        d16 = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED)
        depth = d16.astype(np.float32) / depth_factor
        yield idx / fps, rgb, depth
