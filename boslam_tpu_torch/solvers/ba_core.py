"""Shared bundle-adjustment helpers (the part of ``boslam_tpu.solvers.
ba_core`` that local BA needs)."""

from __future__ import annotations

import torch


def inv3x3(M):
    """Batched 3x3 inverse via adjugate (safe for SPD damped blocks)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack(
        [
            A, -(b * i - c * h), b * f - c * e,
            B, a * i - c * g, -(a * f - c * d),
            C, -(a * h - b * g), a * e - b * d,
        ],
        dim=-1,
    ).reshape(M.shape)
    return adj / det[..., None, None]
