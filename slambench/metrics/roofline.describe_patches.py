"""Kernel ``describe_patches``'s share of its roofline in the traced frames
(``kernels.roofline_pct``)."""

import kernels


def read(run):
    return kernels.roofline_pct(run, "describe_patches")
