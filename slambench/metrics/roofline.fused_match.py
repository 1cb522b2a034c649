"""Kernel B3's share of its roofline in the traced cold start of a kidnap
cell (``kernels_match.roofline_pct``): relocalization's whole-map match,
N frame rows against the pool's visible points."""

import kernels_match


def read(run):
    return kernels_match.roofline_pct(run)
