"""Robust-cost machinery shared by the solvers (Huber kernel, chi2 gating)."""

from __future__ import annotations

import torch


def huber_weight(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for the Huber kernel as a function of squared error:
    1 inside the delta bound, delta/e outside (e = sqrt(chi2))."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, 1.0, delta / e)


def huber_cost(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, 0.5 * chi2, delta * (e - 0.5 * delta))


def octave_inv_sigma2(octave: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Per-octave information weight 1/sigma^2, sigma = scale^octave."""
    return torch.pow(scale_factor, -2.0 * octave.to(torch.float32))


def cho_solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``H x = b`` for symmetric positive definite ``H`` [..., D, D]
    by Cholesky, without a host synchronization.  A failed factorization
    gives NaN, as the reference's ``cho_factor`` does; callers zero
    non-finite steps."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.where((info == 0)[..., None], x, float("nan"))
