"""BoW-bucketed descriptor matching (``boslam_tpu.matching.bow``).

Both sides' word ids come from one Hamming product against the vocabulary
each, and word equality is the admissibility mask of the full distance
matrix: the reference's per-bucket search as batched linear algebra.
"""

from __future__ import annotations

import torch

from boslam_tpu_torch.matching import hamming
from boslam_tpu_torch.matching.rotation import rotation_consistency


def search_by_bow(
    vocab,
    desc_a,
    valid_a,
    desc_b,
    valid_b,
    max_dist: int,
    ratio: float = 0.9,
    mutual: bool = True,
    angle_a=None,
    angle_b=None,
):
    """Match A-side descriptors to B-side within shared vocabulary words.

    ``desc_b`` [..., M, 8] may carry leading batch dims (one B side per
    candidate); A is shared.  Returns (idx [..., N] i32 into B or -1,
    ok [..., N] bool, dist [..., N] i32).
    """
    wa = torch.argmin(hamming.hamming_matrix_mxu(desc_a, vocab), dim=-1)
    wb = torch.argmin(hamming.hamming_matrix_mxu(desc_b, vocab), dim=-1)
    bucket = wa[..., :, None] == wb[..., None, :]
    dist = hamming.hamming_matrix_mxu(desc_a, desc_b)
    idx, ok, mdist = hamming.match_top2(
        dist, valid_a, valid_b, max_dist=max_dist, ratio=ratio,
        mutual=mutual, extra_mask=bucket,
    )
    if angle_a is not None and angle_b is not None:
        j = torch.clamp(idx, 0, angle_b.shape[-1] - 1).long()
        angle_b = angle_b.expand(j.shape[:-1] + angle_b.shape[-1:])
        ok = rotation_consistency(angle_a, torch.gather(angle_b, -1, j), ok)
        idx = torch.where(ok, idx, -1)
    return idx, ok, mdist
