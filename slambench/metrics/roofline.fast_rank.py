"""Kernel ``fast_rank``'s share of its roofline in the traced frames
(``kernels.roofline_pct``)."""

import kernels


def read(run):
    return kernels.roofline_pct(run, "fast_rank")
