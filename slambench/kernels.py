"""The card's published peaks and the least time of the frontend's two
kernels, counted from the config's shapes.

``PEAKS`` is a frozen copy of ``boslam_tpu_torch/utils/timing.py``
(``_PEAKS``) at commit bd2752c: NVIDIA's data sheets, dense rates at the
full power limit, float32 outside the tensor cores (the engine runs with
TF32 off) and HBM bytes/s.  The operation and byte counts per call are
frozen copies of ``chip_smoke.py:check_frontend`` at the same commit:

* ``fast_rank`` (B1, one launch over every pyramid level): each level read
  once and its rank and raw score maps written, 12 bytes a pixel; per score
  pixel (level plus the NMS ring) 16 circle offsets x (1 subtraction + 2
  compares) to find the corners.  The rest of a corner's work (16 x 14 + 18
  operations) depends on the data and is not counted: at 48 operations and
  12 bytes a pixel the kernel is bound by its bytes whatever the corners.
* ``describe_patches`` (B2, one launch over the frame's keypoints): per
  keypoint the 32 x 32 float window and its coordinates read and the angle
  and 8 descriptor words written (4 * 32 * 32 + 44 bytes), plus the
  [32, 512] uint16 pattern table read once.

Nothing imports the port.
"""

from __future__ import annotations

import subprocess

from reference.frontend import pyramid_shapes

PEAKS = (
    ("h100 pcie", 51e12, 2.0e12),
    ("h100 80gb hbm3", 67e12, 3.35e12),
    ("h100 sxm", 67e12, 3.35e12),
)

PATCH = 32
BRIEF_TABLE_BYTES = 32 * 512 * 2


def peaks(name: str):
    """(peak float32 FLOP/s, peak bytes/s) of a card by its name, or None."""
    low = name.lower()
    for key, flops, nbytes in PEAKS:
        if key in low:
            return flops, nbytes
    return None


def power_limit_w():
    """The card's power limit in W as ``nvidia-smi`` reads it, or None."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
        return float(line.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def fast_rank_counts(slam_cfg: dict):
    """(operations, bytes) of one ``fast_rank`` launch."""
    cam, orb = slam_cfg["camera"], slam_cfg["orb"]
    shapes = pyramid_shapes(cam["height"], cam["width"], orb["n_levels"],
                            orb["scale_factor"])
    ops = sum(16 * 3.0 * (h + 2) * (w + 2) for h, w in shapes)
    return ops, sum(12.0 * h * w for h, w in shapes)


def describe_patches_counts(slam_cfg: dict):
    """(operations, bytes) of one ``describe_patches`` launch: bytes only,
    which bound it (the moments and 256 compares a keypoint are ~2,300
    operations against its 4,140 bytes)."""
    n = slam_cfg["orb"]["n_features"]
    ops = n * (2.0 * PATCH * PATCH + 256)
    return ops, n * (4.0 * PATCH * PATCH + 8 + 36) + BRIEF_TABLE_BYTES


COUNTS = {"fast_rank": fast_rank_counts,
          "describe_patches": describe_patches_counts}


def least_time_s(kernel: str, slam_cfg: dict, card_peaks):
    """The least time one launch could take on the card: the larger of
    operations over peak FLOP/s and bytes over peak bytes/s."""
    ops, nbytes = COUNTS[kernel](slam_cfg)
    return max(ops / card_peaks[0], nbytes / card_peaks[1])


def roofline_pct(run: dict, kernel: str):
    """The kernel's share of its roofline in a run's traced frames: the
    least time of one launch over its mean device time per launch, in %;
    None where the run traced no launch of it or the card is unknown."""
    prof = run.get("profile_frames")
    card = peaks(run.get("card", ""))
    if prof is None or card is None:
        return None
    hits = [v for name, v in prof["by_name"].items()
            if kernel + "_kernel" in name]
    launches = sum(n for n, _ in hits)
    seconds = sum(s for _, s in hits)
    if not launches or seconds <= 0:
        return None
    return 100.0 * least_time_s(kernel, run["slam_cfg"], card) / (seconds / launches)
