"""Rotation-consistency histogram filter.

ORB keypoint orientations rotate rigidly with camera roll, so the angle
difference of every correct match falls in the same few histogram bins while
mismatches scatter.  A 30-bin histogram of match angle differences keeps only
matches in the 3 most populated bins.
"""

from __future__ import annotations

import torch

TWO_PI = 6.283185307179586


def rotation_consistency(
    angle_a: torch.Tensor,
    angle_b: torch.Tensor,
    ok: torch.Tensor,
    n_bins: int = 30,
    keep_top: int = 3,
    min_matches: int = 12,
) -> torch.Tensor:
    """Filter matches by dominant relative rotation.

    Args:
      angle_a: [..., N] f32 orientation of the keypoint on side A (radians).
      angle_b: [..., N] f32 orientation of the MATCHED feature on side B.
      ok: [..., N] bool candidate match mask.
      min_matches: below this many candidates the filter is a no-op.

    Returns the refined [..., N] bool mask; leading dims are independent.
    """
    diff = angle_a - angle_b
    rot = torch.fmod(diff, TWO_PI)
    rot = torch.where((rot != 0) & (rot < 0), rot + TWO_PI, rot)
    binw = TWO_PI / n_bins
    b = torch.clamp((rot / binw).to(torch.int32), 0, n_bins - 1).long()
    b = b.expand(ok.shape)
    seg = torch.where(ok, b, n_bins)
    hist = torch.zeros(seg.shape[:-1] + (n_bins + 1,), dtype=torch.float32,
                       device=ok.device)
    hist = hist.scatter_add(-1, seg, torch.ones(seg.shape, device=ok.device))
    hist = hist[..., :n_bins]
    thresh = torch.sort(hist, dim=-1).values[..., -keep_top]
    good_bin = hist >= torch.clamp(thresh, min=1.0)[..., None]
    keep = ok & torch.gather(good_bin, -1, b)
    return torch.where(torch.sum(ok, dim=-1, keepdim=True) >= min_matches,
                       keep, ok)
