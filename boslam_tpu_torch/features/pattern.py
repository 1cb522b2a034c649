"""BRIEF sampling pattern for the rotated-BRIEF descriptor.

The reference gets OpenCV's learned 256-pair pattern through
``cv2.ORB_create().detectAndCompute`` (SURVEY.md §2.2).  Cross-compatibility
with cv2 descriptor bits is NOT required (this engine never mixes descriptors
with cv2's), so we use the original BRIEF-style isotropic Gaussian pattern,
generated deterministically: 256 point pairs ~ N(0, (patch/5)^2), clipped to
radius <= 13 so that any rotation stays inside the 31x31 patch.
"""

from __future__ import annotations

import numpy as np

PATCH = 31
HALF = PATCH // 2
N_BITS = 256
_MAX_R = 13.0


def make_pattern(seed: int = 42) -> np.ndarray:
    """Returns [256, 4] float32 (x1, y1, x2, y2) offsets from patch centre."""
    rng = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 4)).astype(np.float32)
    for pair in (pts[:, 0:2], pts[:, 2:4]):
        r = np.linalg.norm(pair, axis=-1, keepdims=True)
        scale = np.minimum(1.0, _MAX_R / np.maximum(r, 1e-6))
        pair *= scale
    return pts


PATTERN = make_pattern()
